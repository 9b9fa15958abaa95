"""Key-value stores of the port (the port of `mxnet_tpu.kvstore`):
`create("local" | "device")` on one process."""
from .kvstore import KVStore, KVStoreLocal, create

__all__ = ["KVStore", "KVStoreLocal", "create"]
