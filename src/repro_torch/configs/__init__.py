"""Assigned architecture configs. Importing this package populates the
registry in repro.config.base (used by ``get_arch`` / ``--arch``)."""

from repro_torch.configs import (  # noqa: F401
    whisper_large_v3,
    internvl2_1b,
    minicpm_2b,
    minicpm3_4b,
    jamba_v0_1_52b,
    h2o_danube_3_4b,
    deepseek_v3_671b,
    mamba2_370m,
    granite_moe_1b_a400m,
    deepseek_7b,
)

ASSIGNED = [
    "whisper-large-v3",
    "internvl2-1b",
    "minicpm-2b",
    "minicpm3-4b",
    "jamba-v0.1-52b",
    "h2o-danube-3-4b",
    "deepseek-v3-671b",
    "mamba2-370m",
    "granite-moe-1b-a400m",
    "deepseek-7b",
]
