"""Splitting the DSE sweep's flat lane axis over several devices."""
from .sharding import Mesh, flat_shards, mesh_device, pad_batch, padded_len
