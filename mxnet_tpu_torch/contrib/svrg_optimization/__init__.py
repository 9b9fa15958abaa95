"""SVRG (Stochastic Variance Reduced Gradient) optimization (the port of
`mxnet_tpu.contrib.svrg_optimization`).

reference: python/mxnet/contrib/svrg_optimization/ (SVRGModule,
_SVRGOptimizer) — implements Johnson & Zhang (NIPS'13): every
`update_freq` epochs snapshot the parameters w0 and accumulate the full
gradient mu = (1/N) sum_i g(w0, batch_i); each step then descends along
  g_vr = g(w, batch) - g(w0, batch) + mu
whose variance vanishes as w -> w*, permitting constant step sizes.

As in the JAX package, the reference routes mu through special kvstore
keys ("key_full") consumed by an assignment optimizer; here mu lives in
the module, on the gradients' device, and the variance-reduced gradient
is formed in the gradient buffers before the ordinary update: one less
wire protocol, the same math, and the base optimizer stays an unmodified
member of the registry.
"""
from .svrg_module import SVRGModule
from .svrg_optimizer import SVRGOptimizer

__all__ = ["SVRGModule", "SVRGOptimizer"]
