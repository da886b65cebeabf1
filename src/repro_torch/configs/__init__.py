"""Architecture configs of the port (a copy of ``repro.configs``' contract).

``get_config(name)`` returns the full published config;
``get_smoke_config(name)`` a reduced same-family config for the CPU tests.
"""

from repro_torch.configs.base import (
    ArchConfig,
    MLASpec,
    MoESpec,
    SHAPES,
    SSMSpec,
    ShapeSpec,
    applicable_shapes,
    get_config,
    get_smoke_config,
    list_archs,
)

__all__ = [
    "ArchConfig", "MLASpec", "MoESpec", "SSMSpec", "ShapeSpec", "SHAPES",
    "applicable_shapes", "get_config", "get_smoke_config", "list_archs",
]
