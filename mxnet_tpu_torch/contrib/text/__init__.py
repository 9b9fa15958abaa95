"""`mx.contrib.text` — vocabulary + token-embedding utilities.
reference: python/mxnet/contrib/text/__init__.py."""
from . import embedding  # noqa: F401
from . import utils      # noqa: F401
from . import vocab      # noqa: F401
from .vocab import Vocabulary  # noqa: F401
