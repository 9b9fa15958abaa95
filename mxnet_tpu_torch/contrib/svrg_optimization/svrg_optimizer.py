"""SVRG optimizer wrapper (the port of
`mxnet_tpu.contrib.svrg_optimization.svrg_optimizer`).

reference: python/mxnet/contrib/svrg_optimization/svrg_optimizer.py
(_SVRGOptimizer) — a dispatching optimizer: full-gradient keys are plain
assignments (the kvstore stores mu), everything else delegates to the
user's base optimizer. Kept for API parity and for users driving the
kvstore protocol directly; SVRGModule itself applies the variance
reduction in the gradient buffers and only needs the base optimizer.
"""
from ... import optimizer as _opt
from ...optimizer import Optimizer


@Optimizer.register
class SVRGOptimizer(Optimizer):
    """Dispatch optimizer: `index >= full_idx_offset` (or names ending in
    ``_full``) assign the pushed value into the stored weight (mu
    bookkeeping); all other keys delegate to ``default_optimizer``.

    Parameters
    ----------
    default_optimizer : str or Optimizer
        The real update rule (e.g. "sgd").
    full_idx_offset : int
        Keys at or above this index hold full gradients (assignment
        semantics). 0 disables index-based detection.
    """

    def __init__(self, default_optimizer="sgd", full_idx_offset=0,
                 **kwargs):
        # base-Optimizer kwargs are shared with the delegate
        super().__init__(**{k: v for k, v in kwargs.items()
                            if k in ("rescale_grad", "param_idx2name", "wd",
                                     "clip_gradient", "learning_rate",
                                     "lr_scheduler", "begin_num_update",
                                     "multi_precision")})
        if isinstance(default_optimizer, Optimizer):
            self.default_opt = default_optimizer
        else:
            self.default_opt = _opt.create(default_optimizer, **kwargs)
        self.full_idx_offset = full_idx_offset

    def _is_full_key(self, index):
        name = self.idx2name.get(index)
        if name is not None and str(name).endswith("_full"):
            return True
        return self.full_idx_offset > 0 and index >= self.full_idx_offset

    def create_state(self, index, weight):
        if self._is_full_key(index):
            return None
        return self.default_opt.create_state(index, weight)

    def update(self, index, weight, grad, state):
        if self._is_full_key(index):
            # assignment semantics: the "weight" slot stores mu
            weight[:] = grad
            return
        self.default_opt.update(index, weight, grad, state)
