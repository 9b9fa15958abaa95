"""DataParallelExecutorGroup: one executor per context, each bound to a
slice of the batch (the port of `mxnet_tpu.module.executor_group`).
Forward and backward fan out over the executors; `Module.update` sums the
gradients through the kvstore."""
from __future__ import annotations

import torch

from .. import ndarray as nd
from ..context import cpu

__all__ = ["DataParallelExecutorGroup"]


def _split_input_slice(batch_size, work_load_list):
    """reference: executor_group.py (_split_input_slice)."""
    total = sum(work_load_list)
    if batch_size < len(work_load_list):
        raise ValueError("batch size must be larger than the number of "
                         "devices")
    slices = []
    start = 0
    for i, w in enumerate(work_load_list):
        if i == len(work_load_list) - 1:
            end = batch_size
        else:
            end = start + int(round(batch_size * w / total))
        slices.append(slice(start, end))
        start = end
    return slices


class DataParallelExecutorGroup:
    """reference: module/executor_group.py (DataParallelExecutorGroup)."""

    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=None, fixed_param_names=None,
                 grad_req="write", state_names=None, compile_graph=None):
        self.symbol = symbol
        # the whole-graph knob, passed to every executor's bind (None: the
        # MXNET_TPU_WHOLE_GRAPH gate); equal batch slices share one program
        # through the process memo
        self.compile_graph = compile_graph
        self.contexts = contexts
        self.workload = workload or [1] * len(contexts)
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = set(fixed_param_names or [])
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()

        self.data_shapes = None
        self.label_shapes = None
        self.execs = []
        self._slices = None
        self.batch_size = None

        self.grad_req = {}
        for name in self.arg_names:
            if name in self.param_names:
                self.grad_req[name] = ("null" if name in
                                       self.fixed_param_names or
                                       not for_training else grad_req)
            elif inputs_need_grad and for_training:
                self.grad_req[name] = grad_req
            else:
                self.grad_req[name] = "null"

        self.bind_exec(data_shapes, label_shapes, shared_group)

    def bind_exec(self, data_shapes, label_shapes, shared_group=None,
                  reshape=False):
        """Bind one executor per context on its batch slice."""
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        self.batch_size = data_shapes[0].shape[0]
        self._slices = _split_input_slice(self.batch_size, self.workload)
        self.execs = []
        input_shapes = {d.name: tuple(d.shape) for d in data_shapes}
        if label_shapes:
            input_shapes.update({l.name: tuple(l.shape)
                                 for l in label_shapes})
        for i, ctx in enumerate(self.contexts):
            islice = self._slices[i]
            nslice = islice.stop - islice.start
            shapes = {k: (nslice,) + tuple(v[1:])
                      for k, v in input_shapes.items()}
            exec_ = self.symbol.simple_bind(ctx, grad_req=self.grad_req,
                                            compile_graph=self.compile_graph,
                                            **shapes)
            self.execs.append(exec_)
        # grouped views over per-exec arrays
        self.data_arrays = [[e.arg_dict[d.name] for e in self.execs]
                            for d in data_shapes]
        self.label_arrays = None
        if label_shapes:
            self.label_arrays = [[e.arg_dict[l.name] for e in self.execs]
                                 for l in label_shapes]
        self.param_arrays = [[e.arg_dict[name] for e in self.execs]
                             for name in self.param_names]
        self.grad_arrays = [[e.grad_dict.get(name) for e in self.execs]
                            for name in self.param_names] \
            if self.for_training else []
        self.aux_arrays = [[e.aux_dict[name] for e in self.execs]
                           for name in self.aux_names]

    def reshape(self, data_shapes, label_shapes):
        self.bind_exec(data_shapes, label_shapes, reshape=True)

    def set_params(self, arg_params, aux_params, allow_extra=False):
        for exec_ in self.execs:
            exec_.copy_params_from(arg_params, aux_params,
                                   allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """The parameters averaged over the contexts, into host dicts (the
        mean in float64, cast back; one context's copy is exact)."""
        for names, arrays, out in ((self.param_names, self.param_arrays,
                                    arg_params),
                                   (self.aux_names, self.aux_arrays,
                                    aux_params)):
            for name, blocks in zip(names, arrays):
                acc = sum(b._data.detach().to("cpu", torch.float64)
                          for b in blocks) / len(blocks)
                out[name] = nd.NDArray(acc.to(blocks[0]._data.dtype),
                                       ctx=cpu())

    def forward(self, data_batch, is_train=None):
        """Slice batch over executors and run forward."""
        if is_train is None:
            is_train = self.for_training
        data = data_batch.data
        for j, d in enumerate(data):
            for i, islice in enumerate(self._slices):
                src = d[islice.start:islice.stop] \
                    if len(self.contexts) > 1 else d
                if isinstance(src, nd.NDArray):
                    src.copyto(self.data_arrays[j][i])
                else:
                    self.data_arrays[j][i][:] = src
        if self.label_arrays is not None and data_batch.label:
            for j, l in enumerate(data_batch.label):
                for i, islice in enumerate(self._slices):
                    src = l[islice.start:islice.stop] \
                        if len(self.contexts) > 1 else l
                    if isinstance(src, nd.NDArray):
                        src.copyto(self.label_arrays[j][i])
                    else:
                        self.label_arrays[j][i][:] = src
        for exec_ in self.execs:
            exec_.forward(is_train=is_train)

    def get_output_shapes(self):
        outputs = self.execs[0].outputs
        shapes = [o.shape for o in outputs]
        concat_shapes = []
        for key, the_shape in zip(self.symbol.list_outputs(), shapes):
            the_shape = list(the_shape)
            if the_shape and self.batch_size is not None:
                the_shape[0] = self.batch_size
            concat_shapes.append((key, tuple(the_shape)))
        return concat_shapes

    def get_outputs(self, merge_multi_context=True):
        """reference: executor_group.py (get_outputs)."""
        outputs = [[exec_.outputs[i] for exec_ in self.execs]
                   for i in range(len(self.execs[0].outputs))]
        if merge_multi_context:
            return [_merge_multi_context(x) for x in outputs]
        return outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        grads = []
        for d in self.data_shapes:
            per_dev = [e.grad_dict.get(d.name) for e in self.execs]
            grads.append(per_dev)
        if merge_multi_context:
            return [_merge_multi_context(x) for x in grads]
        return grads

    def backward(self, out_grads=None):
        """reference: executor_group.py (backward)."""
        assert self.for_training, "re-bind with for_training=True to run " \
                                  "backward"
        for i, exec_ in enumerate(self.execs):
            islice = self._slices[i]
            og = None
            if out_grads is not None:
                og = []
                for grad in out_grads:
                    if len(self.contexts) > 1:
                        og.append(grad[islice.start:islice.stop]
                                  .as_in_context(self.contexts[i]))
                    else:
                        og.append(grad.as_in_context(self.contexts[i]))
            exec_.backward(out_grads=og)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        """reference: executor_group.py (update_metric)."""
        for current_exec, islice in zip(self.execs, self._slices):
            if not pre_sliced and labels is not None:
                labels_slice = []
                for label in labels:
                    if len(self.contexts) > 1:
                        labels_slice.append(label[islice.start:islice.stop])
                    else:
                        labels_slice.append(label)
            else:
                labels_slice = labels
            eval_metric.update(labels_slice, current_exec.outputs)


def _merge_multi_context(arrays):
    """The per-context slices as one array on the first one's context."""
    if len(arrays) == 1:
        return arrays[0]
    valid = [a for a in arrays if a is not None]
    if not valid:
        return None
    dev = valid[0]._data.device
    return nd.NDArray(torch.cat([a._data.detach().to(dev) for a in valid]),
                      ctx=valid[0].context)
