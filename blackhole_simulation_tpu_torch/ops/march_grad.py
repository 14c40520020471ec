"""The gradient kernel's host side: the plain PyTorch version of the
march's reverse-mode derivative and the wrapper that launches the kernel.

Counterpart of ``blackhole_simulation_tpu/ops/pallas_grad.py``: ``CKPT``
(:68; its ``BH_PALLAS_CKPT`` override is a TPU tuning knob and is not
ported), ``make_composite`` (:71, here ``ops/march.py::march_step_rows``),
``_grad_kernel`` (:149) and ``pallas_march_grad`` (:358). The kernel is
``csrc/march_grad.cu``. ``march_grad`` is its plain version with the same
structure: a checkpointed replay of the march, then, block by block in
reverse, a re-forward into a step stack and a per-step VJP (here
``torch.autograd.grad`` of the step, the kernel's being the hand-written
adjoint of ``csrc/march_adjoint.cuh``) with the crossing and r_min
cotangents injected at the steps that recorded them and the optional
per-step cotangent clip. With the jets (a ``JetParams``) the march is the
jets' march, whose emission every live step adds to the (3, N) jet
radiance: the jet radiance's cotangent enters the VJP of every live step
(the kernel's jets instantiation, ``march_adjoint.cuh::jet_emission_vjp``),
as ``jax.grad`` of the JAX package's jnp march differentiates
``jet_emission_step`` inside its loop (render/march.py:555-569). ``march_grad_kernel`` launches the kernel for CUDA
tensors and runs ``march_grad`` for CPU tensors; nothing else picks between
them. On float64 rays the kernel is two: the replay kernel, then the
reverse kernel on persistent warps that take their rays from the ray pool
and reverse each 4-step block (``CKPT_F64``) from a tape its re-forward
wrote in shared memory (``march_adjoint.cuh::step_tape``,
``march_step_vjp_tape``). The blocks' length does not change the result:
the replay is deterministic. ``step_vjp_check`` and ``renorm_vjp_check`` launch
``csrc/step_vjp_check.cu``, the card's check of the adjoint against the
forward-mode ``Dual<N>`` step and renormalization.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from blackhole_simulation_tpu_torch.ops.march import march_step_rows
from blackhole_simulation_tpu_torch.ops.pallas_march import (
    c_jet_params,
    c_march_params,
    check_dtype,
    load_library,
    ray_pool,
    scalar_params,
)
from blackhole_simulation_tpu_torch.render.march import (
    HIT_HORIZON,
    HIT_NONE,
    clip_rows,
)

CKPT = 8  # steps per checkpoint block, as csrc/march_grad.cu's
CKPT_F64 = 4  # the same of its float64 kernels (CKPT_F64)


def ckpt_of(dtype) -> int:
    """The kernel's steps per checkpoint block for rays of ``dtype``."""
    return CKPT_F64 if dtype == torch.float64 else CKPT


def _blocks(cfg, ckpt: int = CKPT) -> int:
    return -(-cfg.max_steps // ckpt)


def scratch_words(cfg, dtype=torch.float32) -> int:
    """Scratch words per ray of the kernel, of the rays' dtype: the block
    checkpoints, 7 words each (6 state rows, crossing count), and in
    float64 the count of the ray's live blocks, which the replay kernel
    writes for the reverse kernel; the re-forward stack (float64: the tape)
    lives in shared memory."""
    if dtype == torch.float64:
        return _blocks(cfg, CKPT_F64) * 7 + 1
    return _blocks(cfg) * 7


def march_grad(yt0, thr, m, a, r_h, r_ph, cfg, ct_fin, ct_cr, ct_cp, ct_ct,
               ct_rmin, rmin_fin, ct_jet=None, jets=None, ckpt=None):
    """Plain version of the march VJP (``pallas_march_grad``'s contract).

    ``yt0``: (8, N) rows normalized to p_t = -1 (the march's input);
    ``ct_fin``: (8, N) cotangent of the final rows (the p_t row is ignored);
    ``ct_cr/cp/ct``: (K, N) crossing cotangents; ``ct_rmin``, ``rmin_fin``:
    (N,); ``jets``: the jets' ``JetParams`` (the march with their emission)
    with ``ct_jet`` (3, N), the jet radiance's cotangent, or None; ``ckpt``:
    the steps per checkpoint block (by default the kernel's for the rays'
    dtype, ``ckpt_of``), which does not change the result. Returns (ct_yt0
    (8, N) with a zero p_t row, ct_m, ct_a, ct_rh, ct_rph), the scalars
    summed over rays. Always divides exactly.
    """
    k_slots = cfg.max_crossings
    n = yt0.shape[1]
    y0 = yt0.detach()
    pph = y0[7]
    m, a, r_h, r_ph = (torch.as_tensor(x).detach() for x in (m, a, r_h, r_ph))
    thr = thr.detach()
    ckpt = ckpt_of(y0.dtype) if ckpt is None else ckpt
    n_blocks = _blocks(cfg, ckpt)

    # ---- phase 1: replay, checkpoint at the start of every block ----
    with torch.no_grad():
        y6 = tuple(y0[j] for j in (0, 1, 2, 3, 5, 6))
        hit = torch.where(y0[1] < thr, HIT_HORIZON, HIT_NONE).to(torch.int32)
        nc = torch.zeros_like(hit)
        ckpts = []
        for b in range(n_blocks):
            ckpts.append((y6, hit, nc))
            for i in range(b * ckpt, min((b + 1) * ckpt, cfg.max_steps)):
                if not bool((hit == HIT_NONE).any()):
                    break
                (y6, *_), (hit, nc, _, _) = march_step_rows(
                    m, a, r_h, r_ph, thr, cfg, i, y6, pph, hit, nc)

    # ---- phase 2: reverse sweep over blocks ----
    ct6 = torch.stack([ct_fin[j] for j in (0, 1, 2, 3, 5, 6)]).detach()
    ct_pph = ct_fin[7].detach().clone()
    ct_par = torch.zeros((4, n), dtype=y0.dtype, device=y0.device)
    injected = torch.zeros(n, dtype=torch.bool, device=y0.device)
    clip = cfg.cotangent_clip
    if clip > 0.0:
        ct6 = clip_rows(ct6, clip)   # the stopped steps' clips, one
    zero = torch.zeros_like(pph)
    for b in reversed(range(n_blocks)):
        y6, hit, nc = ckpts[b]
        if not bool((hit == HIT_NONE).any()):
            continue
        stack = []
        with torch.no_grad():
            for i in range(b * ckpt, min((b + 1) * ckpt, cfg.max_steps)):
                if not bool((hit == HIT_NONE).any()):
                    break
                stack.append((i, y6, hit, nc))
                (y6, *_), (hit, nc, _, _) = march_step_rows(
                    m, a, r_h, r_ph, thr, cfg, i, y6, pph, hit, nc)
        for i, y6s, hits, ncs in reversed(stack):
            if clip > 0.0:
                ct6 = clip_rows(ct6, clip)
            ins = [x.clone().requires_grad_() for x in y6s]
            ins += [x.expand(n).clone().requires_grad_()
                    for x in (pph, m, a, r_h, r_ph)]
            with torch.enable_grad():
                (y2, r_c, phi_c, t_c, dmin, jet), (_, _, crossed, advance) = (
                    march_step_rows(ins[7], ins[8], ins[9], ins[10], thr,
                                    cfg, i, tuple(ins[:6]), ins[6], hits,
                                    ncs, jets))
                ct_rc, ct_rp, ct_rt = zero, zero, zero
                for k in range(k_slots):
                    sel = crossed & (ncs == k)
                    ct_rc = torch.where(sel, ct_cr[k], ct_rc)
                    ct_rp = torch.where(sel, ct_cp[k], ct_rp)
                    ct_rt = torch.where(sel, ct_ct[k], ct_rt)
                hitmin = advance & (dmin == rmin_fin) & ~injected
                injected = injected | hitmin
                ct_dmin = torch.where(hitmin, ct_rmin, zero)
                outs = [*y2, r_c, phi_c, t_c, dmin]
                cts = [*ct6, ct_rc, ct_rp, ct_rt, ct_dmin]
                if jet is not None:
                    outs.append(jet)
                    cts.append(ct_jet)
                grads = torch.autograd.grad(outs, ins, cts, allow_unused=True)
            grads = [torch.zeros_like(pph) if g is None else g for g in grads]
            ct6 = torch.stack(grads[:6])
            ct_pph = ct_pph + grads[6]
            ct_par = ct_par + torch.stack(grads[7:11])   # m, a, r_h, r_ph

    # r_min's initial-value case: no step came closer than |r0 - r_ph|.
    d0 = y0[1] - r_ph
    init_min = ~injected & (torch.abs(d0) == rmin_fin)
    extra = torch.where(init_min, ct_rmin * torch.sign(d0), zero)
    ct6 = ct6.clone()
    ct6[1] = ct6[1] + extra
    ct_par[3] = ct_par[3] - extra
    ct_yt0 = torch.stack([ct6[0], ct6[1], ct6[2], ct6[3], zero, ct6[4],
                          ct6[5], ct_pph])
    return (ct_yt0, ct_par[0].sum(), ct_par[1].sum(), ct_par[2].sum(),
            ct_par[3].sum())


def march_grad_kernel(yt0, thr, m, a, r_h, r_ph, cfg, ct_fin, ct_cr, ct_cp,
                      ct_ct, ct_rmin, rmin_fin, ct_jet=None, jets=None,
                      replay=None):
    """The march VJP, as ``march_grad``, in the rays' dtype (float32, or
    float64 on the exact route; any other raises). CUDA tensors launch the
    gradient kernel (``csrc/march_grad.cu``; its jets instantiation with
    ``jets``, its float64 one, ``march_grad_kernel_f64``, for float64 rays)
    on the current stream, with a scratch buffer of ``scratch_words(cfg)``
    words of the rays' dtype per ray (its size in bytes is kept in
    ``march_grad_kernel.scratch_bytes``), and count the launch in
    ``march_grad_kernel.launches``; CPU tensors run ``march_grad``. While
    ``march_grad_kernel.record`` is a list, each call appends its arguments
    to it. ``replay``, a contiguous int32 (3, N) CUDA tensor, receives the
    kernel's replay of the forward march: each ray's hit, live steps and
    crossing count, which equal the march kernel's when the replay lands on
    the forward's steps."""
    if march_grad_kernel.record is not None:
        march_grad_kernel.record.append(
            (yt0, thr, m, a, r_h, r_ph, cfg, ct_fin, ct_cr, ct_cp, ct_ct,
             ct_rmin, rmin_fin, ct_jet, jets))
    n = yt0.shape[1]
    check_dtype(yt0, cfg)
    if yt0.shape != (8, n):
        raise ValueError("rays must be (8, N)")
    if cfg.max_crossings < 1:
        raise ValueError("max_crossings must be at least 1")
    if (jets is None) != (ct_jet is None):
        raise ValueError("jets and ct_jet go together")
    if cfg.multistep:
        raise NotImplementedError("the gradient kernel replays the midpoint "
                                  "march; the AB3 march has no gradient")
    if replay is not None and (
            replay.dtype != torch.int32 or replay.shape != (3, n)
            or replay.device != yt0.device or replay.device.type != "cuda"
            or not replay.is_contiguous()):
        raise ValueError("replay must be a contiguous int32 (3, N) tensor on "
                         "the rays' CUDA device")
    if yt0.device.type == "cpu":
        return march_grad(yt0, thr, m, a, r_h, r_ph, cfg, ct_fin, ct_cr,
                          ct_cp, ct_ct, ct_rmin, rmin_fin, ct_jet, jets)
    if yt0.device.type != "cuda":
        raise ValueError(f"no gradient path for device {yt0.device}")
    cty0, ctp = march_grad_rows(yt0, thr, m, a, r_h, r_ph, cfg, ct_fin,
                                ct_cr, ct_cp, ct_ct, ct_rmin, rmin_fin,
                                ct_jet, jets, replay)
    zero = torch.zeros((1, n), dtype=cty0.dtype, device=cty0.device)
    ct_yt0 = torch.cat([cty0[:4], zero, cty0[4:]])
    return ct_yt0, ctp[0].sum(), ctp[1].sum(), ctp[2].sum(), ctp[3].sum()


def march_grad_rows(yt0, thr, m, a, r_h, r_ph, cfg, ct_fin, ct_cr, ct_cp,
                    ct_ct, ct_rmin, rmin_fin, ct_jet=None, jets=None,
                    replay=None):
    """One launch of the gradient kernel on CUDA tensors (the arguments
    ``march_grad_kernel`` takes and checks): the kernel's own per-ray
    outputs, cty0 (7, N), the cotangents of the initial rows (t, r, u, ph,
    p_r, p_u, p_phi), and ctp (4, N), each ray's partials for (m, a, r_h,
    r_ph). Counted in ``march_grad_kernel.launches``."""
    n = yt0.shape[1]
    lib = _grad_library()
    dev = yt0.device
    dtype = yt0.dtype
    f64 = dtype == torch.float64
    flat = lambda x: x.detach().to(dtype).contiguous()
    rows7 = lambda x: flat(torch.cat([x[:4], x[5:8]]))
    y7 = rows7(yt0)
    ctf = rows7(ct_fin)
    ctc = flat(torch.cat([ct_cr, ct_cp, ct_ct]))
    thr, ct_rmin, rmin_fin = flat(thr), flat(ct_rmin), flat(rmin_fin)
    ctj = None if jets is None else flat(ct_jet)
    params = scalar_params(m, a, r_h, r_ph, dev, dtype)
    cty0 = torch.empty((7, n), dtype=dtype, device=dev)
    ctp = torch.empty((4, n), dtype=dtype, device=dev)
    words = (lib.bh_march_grad_scratch64 if f64
             else lib.bh_march_grad_scratch)(cfg.max_steps)
    if words != scratch_words(cfg, dtype):
        raise RuntimeError("scratch layout differs between csrc/march_grad.cu "
                           "and ops/march_grad.py")
    scratch = torch.empty(words * n, dtype=dtype, device=dev)
    c_mp = c_march_params(cfg, dtype)
    c_jets = c_jet_params(jets, dtype)
    c_real = ctypes.c_double if f64 else ctypes.c_float
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # float64: the replay and reverse kernels, the latter's rays from
        # the ray pool of the stream (ops/pallas_march.py::ray_pool)
        pool = (ptr(ray_pool(dev)),) if f64 else ()
        launch = (lib.bh_march_grad_launch64 if f64
                  else lib.bh_march_grad_launch)
        err = launch(
            ptr(params), ptr(y7), ptr(thr), ptr(ctf), ptr(ctc), ptr(ct_rmin),
            ptr(rmin_fin), ptr(cty0), ptr(ctp), ptr(scratch),
            ctypes.c_void_p(0 if replay is None else replay.data_ptr()),
            *pool, ctypes.c_int(n), ctypes.byref(c_mp),
            c_real(cfg.cotangent_clip),
            ctypes.c_void_p(0 if ctj is None else ctj.data_ptr()),
            None if jets is None else ctypes.byref(c_jets),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"gradient kernel launch failed: {lib.bh_error_string(err).decode()}")
    march_grad_kernel.launches += 1
    march_grad_kernel.scratch_bytes = scratch.numel() * scratch.element_size()
    return cty0, ctp




march_grad_kernel.launches = 0
march_grad_kernel.scratch_bytes = 0
march_grad_kernel.record = None


def grad_kernel_shape(approx: bool = True, jets: bool = False,
                      dtype=torch.float32) -> dict:
    """The gradient kernel's launch shape, from the built library: threads
    per block, dynamic shared memory bytes per block, steps per checkpoint
    block, and resident blocks and warps per SM by
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` (on the current
    device), of the instantiation for ``MarchConfig.approx_recip`` =
    ``approx`` (the training step's route by default), ``jets`` and
    ``dtype``. Float64 (the exact route's, whatever ``approx``): the
    reverse kernel's, and under ``replay`` its replay kernel's threads per
    block and resident blocks and warps per SM."""
    out = (ctypes.c_int * 6)()
    lib = _grad_library()
    if dtype == torch.float64:
        lib.bh_march_grad_shape64(ctypes.c_int(int(jets)), out)
    else:
        lib.bh_march_grad_shape(ctypes.c_int(int(approx)),
                                ctypes.c_int(int(jets)), out)
    threads, smem, ckpt, blocks, r_threads, r_blocks = out
    shape = {"threads": threads, "smem_bytes": smem, "ckpt": ckpt,
             "blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32}
    if dtype == torch.float64:
        shape["replay"] = {"threads": r_threads, "blocks_per_sm": r_blocks,
                           "warps_per_sm": r_blocks * r_threads // 32}
    return shape


def step_vjp_check(yt0, thr, m, a, r_h, r_ph, cfg, cts, steps):
    """Both per-step derivatives of the gradient kernel on the card, on the
    same states and cotangents (``csrc/step_vjp_check.cu``): each ray of
    ``yt0`` (8, N) is marched from its rows, and at each of its first
    ``steps`` live steps the hand-written adjoint and the forward-mode
    ``Dual<11>`` pass take the VJP with the output cotangents formed from
    ``cts`` (10, N): the six carry rows, the crossing record's three where
    the step crossed, dmin's where it advanced. Returns a dict of
    ``adjoint``, ``dual`` (11, steps, N), the input cotangents by the two
    routes; ``size`` (11, steps, N), the sum of the sizes of the terms the
    dual pass adds up (|cotangent x partial|); ``state`` (7, steps, N), the
    pre-step (t, r, u, ph, pr, pu) and crossing count; ``live`` (steps, N)
    bool. CUDA tensors only: there is no plain version of a comparison of
    two kernels."""
    if yt0.device.type != "cuda":
        raise ValueError("step_vjp_check runs on a CUDA device")
    lib = _check_library()
    dev = yt0.device
    n = yt0.shape[1]
    y7 = torch.cat([yt0[:4], yt0[5:8]]).detach().float().contiguous()
    thr = thr.detach().float().contiguous()
    cts = cts.detach().float().contiguous()
    params = scalar_params(m, a, r_h, r_ph, dev)
    out = {k: torch.empty((rows, steps, n), dtype=torch.float32, device=dev)
           for k, rows in (("adjoint", 11), ("dual", 11), ("size", 11),
                           ("state", 7))}
    live = torch.empty((steps, n), dtype=torch.int32, device=dev)
    c_mp = c_march_params(cfg)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bh_step_vjp_check_launch(
            ptr(params), ptr(y7), ptr(thr), ptr(cts), ptr(out["adjoint"]),
            ptr(out["dual"]), ptr(out["size"]), ptr(out["state"]), ptr(live),
            ctypes.c_int(n), ctypes.c_int(steps), ctypes.byref(c_mp),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"step check launch failed: {lib.bh_error_string(err).decode()}")
    out["live"] = live.bool()
    return out


def renorm_vjp_check(q):
    """The renormalization's VJP on the card by both routes
    (``csrc/step_vjp_check.cu``): ``q`` (8, N) float32 rows m, a, r, u,
    pr, pu, pph and the cotangent of the projected p_r. Returns (adjoint,
    dual), each (7, N): the cotangents of (m, a, r, u, pr, pu, pph) by the
    hand-written ``renormalize_pr_vjp`` and by ``ks_renormalize_pr`` on
    ``Dual<7>``. CUDA tensors only."""
    if q.device.type != "cuda":
        raise ValueError("renorm_vjp_check runs on a CUDA device")
    lib = _check_library()
    q = q.detach().float().contiguous()
    n = q.shape[1]
    adj = torch.empty((7, n), dtype=torch.float32, device=q.device)
    dual = torch.empty_like(adj)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.bh_renorm_vjp_check_launch(
            ptr(q), ptr(adj), ptr(dual), ctypes.c_int(n),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"renorm check launch failed: {lib.bh_error_string(err).decode()}")
    return adj, dual


def minmax_check(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The float jmax and jmin of ``csrc/march_step.cuh`` (one FMNMX each)
    and the compare-compare-select form they replaced, on the card, for
    each pair of the float32 (N,) tensors a, b: (4, N) rows jmax, the old
    jmax, jmin, the old jmin. CUDA tensors only: it compares two device
    instructions."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("minmax_check runs on a CUDA device")
    lib = _check_library()
    a = a.detach().float().contiguous()
    b = b.detach().float().contiguous()
    n = a.shape[0]
    out = torch.empty((4, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.bh_minmax_check_launch(
            ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
            ctypes.c_void_p(out.data_ptr()), ctypes.c_int(n),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"min/max check launch failed: {lib.bh_error_string(err).decode()}")
    return out


@functools.cache
def _check_library() -> ctypes.CDLL:
    lib = load_library("step_vjp_check.cu", "bh_march_params_size")
    lib.bh_step_vjp_check_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p])
    lib.bh_step_vjp_check_launch.restype = ctypes.c_int
    lib.bh_renorm_vjp_check_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
    lib.bh_renorm_vjp_check_launch.restype = ctypes.c_int
    lib.bh_minmax_check_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
    lib.bh_minmax_check_launch.restype = ctypes.c_int
    return lib


@functools.cache
def _grad_library() -> ctypes.CDLL:
    lib = load_library("march_grad.cu", "bh_march_params_size")
    # the float64 launch takes the ray pool after the replay pointer
    for launch, real, ptrs in ((lib.bh_march_grad_launch, ctypes.c_float, 11),
                               (lib.bh_march_grad_launch64, ctypes.c_double,
                                12)):
        launch.argtypes = (
            [ctypes.c_void_p] * ptrs + [ctypes.c_int, ctypes.c_void_p, real]
            + [ctypes.c_void_p] * 3)
        launch.restype = ctypes.c_int
    lib.bh_march_grad_shape64.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.bh_march_grad_shape64.restype = None
    for scratch in (lib.bh_march_grad_scratch, lib.bh_march_grad_scratch64):
        scratch.argtypes = [ctypes.c_int]
        scratch.restype = ctypes.c_int
    lib.bh_march_grad_shape.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
    lib.bh_march_grad_shape.restype = None
    return lib
