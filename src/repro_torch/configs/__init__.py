"""Registry of the architectures the port serves: each module holds one
configuration and its ``smoke()`` reduction for CPU tests."""
from .common import get_config, get_smoke_config, list_archs
