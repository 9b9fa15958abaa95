"""`mx.io`: data iterators (`io.io`), the reference's C++ iterators over
RecordIO packs, CSV and MNIST files (`io.image_iters`), and the `.params`
format (`params_serde`)."""
from . import params_serde
from .image_iters import (CSVIter, ImageDetRecordIter, ImageRecordIter,
                          ImageRecordUInt8Iter, MNISTIter)
from .io import (DataBatch, DataDesc, DataIter, LibSVMIter, NDArrayIter,
                 PrefetchingIter, ResizeIter)

__all__ = ["params_serde", "DataDesc", "DataBatch", "DataIter",
           "NDArrayIter", "ResizeIter", "PrefetchingIter", "LibSVMIter",
           "ImageRecordIter", "ImageRecordUInt8Iter", "CSVIter", "MNISTIter",
           "ImageDetRecordIter"]
