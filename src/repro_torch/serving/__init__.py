"""Port of ``repro.serving``."""

from repro_torch.serving.blockpool import BlockAllocator, PrefixCache  # noqa: F401
from repro_torch.serving.dispatch import FleetDispatcher, get_pool  # noqa: F401
from repro_torch.serving.engine import Request, ServeEngine  # noqa: F401
