"""Host milliseconds of the parameter row per frame: the self time of the
program's ``host_row`` spans (``render/pipeline.py::kernel_inputs``: the
row's build and ``RenderStatic``), less their ``row_upload`` children."""

from benchmark import program


def read(ctx):
    got = program.recorded()
    if got is None:
        return None
    return 1e3 * program.self_seconds(got, "host_row") / got.frames
