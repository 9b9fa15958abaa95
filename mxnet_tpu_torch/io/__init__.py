"""`mx.io`: data iterators (`io.io`) and the `.params` format
(`params_serde`). The image iterators (`ImageRecordIter`, `CSVIter`,
`MNISTIter`) come with a later slice."""
from . import params_serde
from .io import (DataBatch, DataDesc, DataIter, LibSVMIter, NDArrayIter,
                 PrefetchingIter, ResizeIter)

__all__ = ["params_serde", "DataDesc", "DataBatch", "DataIter",
           "NDArrayIter", "ResizeIter", "PrefetchingIter", "LibSVMIter"]
