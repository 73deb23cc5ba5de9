# copied from mxnet_tpu/visualization.py (backend-free)
"""Network visualization (reference: python/mxnet/visualization.py).

``print_summary`` walks the Symbol graph printing a per-layer table with
output shapes and parameter counts; ``plot_network`` renders via graphviz
when available."""
from __future__ import annotations


from .base import MXNetError

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120, positions=(0.44, 0.64, 0.74, 1.0)):
    """Print a layer-by-layer summary (reference: visualization.py
    print_summary)."""
    shape_dict = {}
    data_names = set(shape or ())
    if shape is not None:
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shape)
        shape_dict = dict(zip(symbol.list_arguments(), arg_shapes))
        shape_dict.update(zip(symbol.list_auxiliary_states(), aux_shapes))

    topo = symbol._topo()
    positions = [int(line_length * p) for p in positions]
    fields = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(f, pos):
        line = ""
        for i, field in enumerate(f):
            line += str(field)
            line = line[: pos[i]]
            line += " " * (pos[i] - len(line))
        print(line)

    print("_" * line_length)
    print_row(fields, positions)
    print("=" * line_length)
    total_params = 0
    for node in topo:
        if node.is_variable:
            continue
        params = 0
        for inp, _ in node.inputs:
            if inp.is_variable and inp.name in shape_dict and inp.name not in data_names:
                import numpy as np

                params += int(np.prod(shape_dict[inp.name]))
        total_params += params
        prevs = ",".join(i.name for i, _ in node.inputs if not i.is_variable)
        out_shape = ""
        print_row(["%s (%s)" % (node.name, node.op), out_shape, params, prevs], positions)
    print("=" * line_length)
    print("Total params: %d" % total_params)
    print("_" * line_length)
    return total_params


def plot_network(symbol, title="plot", shape=None, node_attrs=None):
    """Render the graph with graphviz (reference: visualization.py
    plot_network). Raises if graphviz is unavailable."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise MXNetError("plot_network requires the graphviz package") from e
    node_attrs = dict(node_attrs or {})
    attrs = {"shape": "box", "fixedsize": "false"}
    attrs.update(node_attrs)
    dot = Digraph(name=title)
    topo = symbol._topo()
    for node in topo:
        if node.is_variable:
            dot.node(name=node.name, label=node.name, shape="oval")
        else:
            dot.node(name=node.name, label="%s\n%s" % (node.name, node.op), **attrs)
    for node in topo:
        for inp, _ in node.inputs:
            dot.edge(tail_name=inp.name, head_name=node.name)
    return dot
