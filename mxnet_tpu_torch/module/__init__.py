"""The Module API (the port of `mxnet_tpu.module`)."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .module import Module

__all__ = ["BaseModule", "Module", "BucketingModule",
           "DataParallelExecutorGroup"]
