"""Model-architecture visualization; the port's copy of
ip_avsr_tpu/utils/draw_net.py.

Parity with utils/draw_net.py (get_pydot_graph :61, draw_to_file :130,
draw_to_notebook :147): emit a graph of the model's layer DAG, to a file or
inline in a notebook.  The DAG comes from an
:class:`~ip_avsr_torch.models.adenet.AdeNetConfig` (the composer's
declarative form) rather than from introspecting a framework graph.  Output
is Graphviz dot text; rendering to PNG uses pydot when it is installed and
matplotlib otherwise (both optional, as IPython is).
"""

from __future__ import annotations


def _esc(s: str) -> str:
    return s.replace('"', r"\"")


def config_to_dot(config, name: str = "adenet") -> str:
    """AdeNetConfig -> graphviz dot source describing the layer DAG."""
    lines = [f'digraph "{_esc(name)}" {{', "  rankdir=TB;",
             '  node [shape=record, fontsize=10];']
    fuse_inputs = []
    for spec in config.streams:
        sid = spec.name
        prev = f"in_{sid}"
        lines.append(f'  {prev} [label="input {sid}|dim {spec.input_dim}"];')
        if spec.encoder_shapes:
            node = f"enc_{sid}"
            shape_str = "-".join(str(s) for s in spec.encoder_shapes)
            lines.append(f'  {node} [label="encoder {sid}|{shape_str}"];')
            lines.append(f"  {prev} -> {node};")
            prev = node
        if spec.use_batchnorm:
            node = f"bn_{sid}"
            lines.append(f'  {node} [label="batchnorm {sid}"];')
            lines.append(f"  {prev} -> {node};")
            prev = node
        if spec.use_delta:
            node = f"delta_{sid}"
            lines.append(f'  {node} [label="delta {sid}|win {config.window}|x3"];')
            lines.append(f"  {prev} -> {node};")
            prev = node
        if spec.dropout:
            node = f"drop_{sid}"
            lines.append(f'  {node} [label="dropout {sid}|p {spec.dropout}"];')
            lines.append(f"  {prev} -> {node};")
            prev = node
        if spec.use_lstm:
            node = f"lstm_{sid}"
            lines.append(f'  {node} [label="lstm {sid}|{config.stream_lstm_size(spec)}"];')
            lines.append(f"  {prev} -> {node};")
            prev = node
        fuse_inputs.append(prev)

    lines.append(f'  fuse [label="fusion|{config.fusiontype}"];')
    for node in fuse_inputs:
        lines.append(f"  {node} -> fuse;")
    prev = "fuse"
    for i, size in enumerate(config.aggregator_sizes()):
        kind = "blstm" if config.agg_bidirectional else "lstm"
        node = f"agg{i}"
        lines.append(f'  {node} [label="{kind} agg {i + 1}|{size}"];')
        lines.append(f"  {prev} -> {node};")
        prev = node
    head = ("softmax per-step" if config.output_mode == "per_step"
            else "slice(-1) + softmax")
    lines.append(f'  out [label="{head}|{config.output_classes} classes"];')
    lines.append(f"  {prev} -> out;")
    lines.append("}")
    return "\n".join(lines)


def _graph_nodes_edges(config):
    """The layer DAG as (nodes, edges): nodes is {id: (label, column)} with
    one column per stream and a center column for fusion/aggregator/head;
    edges is a list of (src, dst).  Shared layout backing both the dot
    emitter and the notebook renderer."""
    nodes, edges = {}, []
    fuse_inputs = []
    for col, spec in enumerate(config.streams):
        sid = spec.name
        prev = f"in_{sid}"
        nodes[prev] = (f"input {sid}\ndim {spec.input_dim}", col)
        if spec.encoder_shapes:
            node = f"enc_{sid}"
            nodes[node] = (f"encoder {sid}\n"
                           + "-".join(str(s) for s in spec.encoder_shapes), col)
            edges.append((prev, node)); prev = node
        if spec.use_batchnorm:
            node = f"bn_{sid}"
            nodes[node] = (f"batchnorm {sid}", col)
            edges.append((prev, node)); prev = node
        if spec.use_delta:
            node = f"delta_{sid}"
            nodes[node] = (f"delta {sid}\nwin {config.window} x3", col)
            edges.append((prev, node)); prev = node
        if spec.dropout:
            node = f"drop_{sid}"
            nodes[node] = (f"dropout {sid}\np {spec.dropout}", col)
            edges.append((prev, node)); prev = node
        if spec.use_lstm:
            node = f"lstm_{sid}"
            nodes[node] = (f"lstm {sid}\n{config.stream_lstm_size(spec)}", col)
            edges.append((prev, node)); prev = node
        fuse_inputs.append(prev)
    center = (len(config.streams) - 1) / 2.0
    nodes["fuse"] = (f"fusion\n{config.fusiontype}", center)
    for node in fuse_inputs:
        edges.append((node, "fuse"))
    prev = "fuse"
    for i, size in enumerate(config.aggregator_sizes()):
        kind = "blstm" if config.agg_bidirectional else "lstm"
        node = f"agg{i}"
        nodes[node] = (f"{kind} agg {i + 1}\n{size}", center)
        edges.append((prev, node)); prev = node
    head = ("softmax per-step" if config.output_mode == "per_step"
            else "slice(-1) + softmax")
    nodes["out"] = (f"{head}\n{config.output_classes} classes", center)
    edges.append((prev, "out"))
    return nodes, edges


def render_png_bytes(config, name: str = "adenet") -> bytes:
    """Render the layer DAG to PNG bytes.  Prefers pydot+graphviz (the
    reference's renderer); falls back to a matplotlib box-and-arrow drawing
    so notebooks work without graphviz installed."""
    try:
        import pydot

        graph = pydot.graph_from_dot_data(config_to_dot(config, name))[0]
        return graph.create_png()
    except Exception:
        pass

    import io

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    nodes, edges = _graph_nodes_edges(config)
    # row = longest-path depth so every edge points downward
    depth = {nid: 0 for nid in nodes}
    for _ in range(len(nodes)):
        for s, d in edges:
            depth[d] = max(depth[d], depth[s] + 1)
    pos = {nid: (col * 2.6, -depth[nid] * 1.4)
           for nid, (label, col) in nodes.items()}
    n_rows = max(depth.values()) + 1
    n_cols = len(config.streams)
    fig, ax = plt.subplots(figsize=(max(4, 2.8 * n_cols), max(4, 1.3 * n_rows)))
    for s, d in edges:
        (x0, y0), (x1, y1) = pos[s], pos[d]
        ax.annotate("", xy=(x1, y1 + 0.45), xytext=(x0, y0 - 0.45),
                    arrowprops=dict(arrowstyle="->", color="0.3"))
    for nid, (label, col) in nodes.items():
        x, y = pos[nid]
        ax.text(x, y, label, ha="center", va="center", fontsize=8,
                bbox=dict(boxstyle="round,pad=0.35", facecolor="#dce6f2",
                          edgecolor="0.3"))
    ax.set_title(name)
    ax.axis("off")
    # explicit limits, NOT bbox_inches="tight": tight-bbox computation over
    # arrow annotations is pathologically slow (minutes) in matplotlib's Agg
    # backend here
    xs = [p[0] for p in pos.values()]
    ys = [p[1] for p in pos.values()]
    ax.set_xlim(min(xs) - 1.5, max(xs) + 1.5)
    ax.set_ylim(min(ys) - 1.0, max(ys) + 1.0)
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=110)
    plt.close(fig)
    return buf.getvalue()


def draw_to_notebook(config, name: str = "adenet"):
    """Render the model DAG inline in a notebook (utils/draw_net.py:147-157).

    Returns an ``IPython.display.Image`` of the rendered PNG (raw PNG bytes
    when IPython isn't importable, e.g. from a plain script)."""
    png = render_png_bytes(config, name)
    try:
        from IPython.display import Image
    except Exception:
        return png
    return Image(png)


def draw_to_file(config, filename: str, name: str = "adenet"):
    """Write the DAG: .dot always works; .png/.pdf need pydot+graphviz."""
    dot_src = config_to_dot(config, name)
    if filename.endswith(".dot"):
        with open(filename, "w") as f:
            f.write(dot_src)
        return filename
    try:
        import pydot

        graph = pydot.graph_from_dot_data(dot_src)[0]
        ext = filename.rsplit(".", 1)[-1]
        graph.write(filename, format=ext)
        return filename
    except Exception:
        pass
    if filename.endswith(".png"):
        # no pydot/graphviz: the matplotlib renderer still makes a real PNG.
        # Render BEFORE opening so a renderer failure can't truncate an
        # existing file / leave a 0-byte .png next to the .dot fallback.
        try:
            png = render_png_bytes(config, name)
        except Exception:
            png = None
        if png is not None:
            with open(filename, "wb") as f:
                f.write(png)
            return filename
    fallback = filename.rsplit(".", 1)[0] + ".dot"
    with open(fallback, "w") as f:
        f.write(dot_src)
    return fallback
