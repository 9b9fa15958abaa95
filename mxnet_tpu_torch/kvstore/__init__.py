"""Key-value stores of the port (the port of `mxnet_tpu.kvstore`):
`create("local" | "device")` on one process, `create("dist_sync" |
"dist_device_sync" | "dist_async" | "dist")` across processes."""
from .kvstore import KVStore, KVStoreLocal, ReadyPushSession, create
from .kvstore_dist import DistZeroComm, GradientCompression, KVStoreDist

__all__ = ["KVStore", "KVStoreLocal", "ReadyPushSession", "create",
           "KVStoreDist", "GradientCompression", "DistZeroComm"]
