"""The app shell: the CLI, the live loop, the animation driver, shareable
state, settings and screenshots (counterpart of
``blackhole_simulation_tpu/app``)."""

from blackhole_simulation_tpu_torch.app.animate import AnimationDriver
from blackhole_simulation_tpu_torch.app.screenshot import save_png
from blackhole_simulation_tpu_torch.app.state import (
    SettingsStorage,
    decode_state,
    encode_state,
)

__all__ = [
    "AnimationDriver",
    "save_png",
    "SettingsStorage",
    "decode_state",
    "encode_state",
]
