"""TensorBoard logging callback (reference: python/mxnet/contrib/
tensorboard.py — a thin wrapper over the external `tensorboard`/`mxboard`
SummaryWriter; the reference also hard-depends on that pip package and
raises at use if it is absent).
"""
from __future__ import annotations

__all__ = ["LogMetricsCallback"]


class LogMetricsCallback:
    """Log eval metrics to TensorBoard event files each time it is invoked
    (pass as `eval_metric_callback` / batch-end callback to `fit`).

    reference: contrib/tensorboard.py (LogMetricsCallback). Requires the
    external `tensorboardX`/`tensorboard` package, exactly like the
    reference; constructing without one raises ImportError.
    """

    def __init__(self, logging_dir, prefix=None):
        self.prefix = prefix
        writer_cls = None
        for mod, attr in (("tensorboardX", "SummaryWriter"),
                          ("torch.utils.tensorboard", "SummaryWriter")):
            try:
                writer_cls = getattr(__import__(mod, fromlist=[attr]), attr)
                break
            except ImportError:
                continue
        if writer_cls is None:
            raise ImportError(
                "LogMetricsCallback requires a TensorBoard SummaryWriter "
                "(pip install tensorboardX), matching the reference's "
                "external dependency")
        self.summary_writer = writer_cls(logging_dir)
        self.step = 0

    def __call__(self, param):
        if param.eval_metric is None:
            return
        self.step += 1
        for name, value in param.eval_metric.get_name_value():
            if self.prefix is not None:
                name = "%s-%s" % (self.prefix, name)
            self.summary_writer.add_scalar(name, value, self.step)
