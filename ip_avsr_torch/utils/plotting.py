"""Reporting utilities: loss curves, image tiles, network printout; the
port's copy of ip_avsr_tpu/utils/plotting.py.

Parity targets: utils/plotting_utils.py (plot_validation_cost :132,
tile_raster_images :12, visualize_reconstruction :163-223, print_network
:278).  matplotlib is imported inside each renderer with the ``Agg``
backend, so headless training never touches it.
"""

from __future__ import annotations

import numpy as np


def plot_validation_cost(train_costs, val_costs, class_rate=None, savefilename=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    epochs = np.arange(1, len(train_costs) + 1)
    fig, ax1 = plt.subplots()
    ax1.plot(epochs, train_costs, label="train cost")
    ax1.plot(epochs, val_costs, label="validation cost")
    ax1.set_xlabel("epoch")
    ax1.set_ylabel("cost")
    if class_rate is not None:
        ax2 = ax1.twinx()
        ax2.plot(epochs, class_rate, "g--", label="classification rate")
        ax2.set_ylabel("classification rate")
    ax1.legend(loc="best")
    if savefilename:
        fig.savefig(f"{savefilename}")
    plt.close(fig)


def scale_to_unit_interval(ndar, eps=1e-8):
    """Scale an array to [0, 1] (utils/plotting_utils.py:122-129: subtract
    the min, then divide by max-after-subtraction + eps)."""
    ndar = np.asarray(ndar, dtype=np.float64).copy()
    ndar -= ndar.min()
    ndar *= 1.0 / (ndar.max() + eps)
    return ndar


def tile_raster_images(X, img_shape, tile_shape, tile_spacing=(0, 0),
                       scale_rows_to_unit_interval=True,
                       output_pixel_vals=True):
    """Tile flattened images (one per row of ``X``) into a single 2-D array.

    Full utils/plotting_utils.py:12-119 semantics:
      * ``X`` may be a 2-D array (grayscale) or a 4-tuple of per-channel
        arrays/None (RGBA; None channels fill with 0 color / opaque alpha).
      * ``scale_rows_to_unit_interval`` — per-image min/max scaling via
        :func:`scale_to_unit_interval` (eps-regularized divisor, matching
        the reference pixel-for-pixel) vs raw values.
      * ``output_pixel_vals`` — uint8 output (values * 255, C-cast on the
        store as in the reference) vs the input's float values.
    Unlike the reference this never touches matplotlib (headless library
    code; rendering happens in the visualize_* wrappers)."""
    assert len(img_shape) == 2
    assert len(tile_shape) == 2
    assert len(tile_spacing) == 2
    out_shape = [(ishp + tsp) * tshp - tsp
                 for ishp, tshp, tsp in zip(img_shape, tile_shape, tile_spacing)]

    if isinstance(X, tuple):
        assert len(X) == 4
        if output_pixel_vals:
            dtype = np.dtype("uint8")
            channel_defaults = [0, 0, 0, 255]
        else:
            # reference reads X.dtype here, which a tuple doesn't have (it
            # only ever passes arrays in the non-tuple branch); use the
            # first present channel's dtype instead of crashing
            present = [c for c in X if c is not None]
            dtype = np.asarray(present[0]).dtype if present else np.dtype(np.float64)
            channel_defaults = [0.0, 0.0, 0.0, 1.0]
        out_array = np.zeros((out_shape[0], out_shape[1], 4), dtype=dtype)
        for i in range(4):
            if X[i] is None:
                out_array[:, :, i] = np.zeros(out_shape, dtype=dtype) + channel_defaults[i]
            else:
                out_array[:, :, i] = tile_raster_images(
                    np.asarray(X[i]), img_shape, tile_shape, tile_spacing,
                    scale_rows_to_unit_interval, output_pixel_vals)
        return out_array

    X = np.asarray(X)
    H, W = img_shape
    Hs, Ws = tile_spacing
    out_array = np.zeros(out_shape,
                         dtype=np.uint8 if output_pixel_vals else X.dtype)
    for tile_row in range(tile_shape[0]):
        for tile_col in range(tile_shape[1]):
            idx = tile_row * tile_shape[1] + tile_col
            if idx >= X.shape[0]:
                continue
            img = X[idx].reshape(img_shape)
            if scale_rows_to_unit_interval:
                img = scale_to_unit_interval(img)
            out_array[tile_row * (H + Hs): tile_row * (H + Hs) + H,
                      tile_col * (W + Ws): tile_col * (W + Ws) + W] = \
                img * (255 if output_pixel_vals else 1)
    return out_array


def _save_tile(vis, savefilename, title):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.imshow(vis, cmap="gray")
    ax.set_title(title)
    ax.axis("off")
    if savefilename:
        fig.savefig(f"{savefilename}.png" if not str(savefilename).endswith(".png")
                    else savefilename)
    plt.close(fig)
    return vis


def visualize_images(images, shape=(30, 40), savefilename=None):
    """Square tile grid of flattened images (utils/plotting_utils.py:163-171;
    headless: renders to ``savefilename``.png instead of plt.show)."""
    w = int(np.sqrt(len(images)))
    vis = tile_raster_images(images, shape, (w, w), tile_spacing=(1, 1))
    return _save_tile(vis, savefilename, "images")


def visualize_sequence(sequence, shape=(30, 40), savefilename=None, title="sequence"):
    """2-row tile of a frame sequence (utils/plotting_utils.py:174-183)."""
    cols = int(np.ceil(len(sequence) / 2.0))
    vis = tile_raster_images(sequence, shape, (2, cols), tile_spacing=(1, 1))
    return _save_tile(vis, savefilename, title)


def visualize_layer(weights, row, col, w, h, savefilename=None):
    """Tile a weight matrix's columns as (row, col) filters in a (w, h) grid
    (utils/plotting_utils.py:203-208; takes the array, not a Lasagne layer)."""
    vis = tile_raster_images(np.asarray(weights).T, (row, col), (w, h),
                             tile_spacing=(1, 1))
    return _save_tile(vis, savefilename, "filters")


def visualize_activations(weights, examples, shape, weight_idx_to_visualize,
                          savefilename=None):
    """Per-weight-column activation overlays vs raw examples
    (utils/plotting_utils.py:211-223)."""
    weights = np.asarray(weights)
    outs = []
    for i in weight_idx_to_visualize:
        activations = weights[:, i] * np.asarray(examples)
        name = f"{savefilename}_w{i}" if savefilename else None
        outs.append(visualize_reconstruction(examples, activations, shape, name))
    return outs


def show_image(data, shape, order="f", savefilename=None):
    """Render one flattened image (utils/plotting_utils.py:255-266; headless:
    writes a PNG instead of opening a window)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = np.asarray(data).reshape(shape, order=order)
    fig, ax = plt.subplots()
    ax.imshow(img, cmap="gray")
    if savefilename:
        fig.savefig(savefilename)
    plt.close(fig)
    return img


def visualize_reconstruction(original, reconstructed, shape=(30, 40), savefilename=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(original)
    side = int(np.ceil(np.sqrt(n)))
    fig, (ax1, ax2) = plt.subplots(1, 2)
    ax1.imshow(tile_raster_images(original, shape, (side, side)), cmap="gray")
    ax1.set_title("original")
    ax1.axis("off")
    ax2.imshow(tile_raster_images(reconstructed, shape, (side, side)), cmap="gray")
    ax2.set_title("reconstruction")
    ax2.axis("off")
    if savefilename:
        fig.savefig(savefilename)
    plt.close(fig)


def plot_confusion_matrix_image(cm, classnames, savefilename=None, cmap="Blues"):
    """Render a confusion matrix as an annotated heatmap PNG — the graphical
    counterpart of the tabulate tables (avletters/confusion_visualizer.py
    role)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cm = np.asarray(cm)
    fig, ax = plt.subplots(figsize=(max(4, len(classnames) * 0.5),) * 2)
    im = ax.imshow(cm, cmap=cmap)
    ax.set_xticks(range(len(classnames)), classnames, rotation=90)
    ax.set_yticks(range(len(classnames)), classnames)
    ax.set_xlabel("predicted")
    ax.set_ylabel("actual")
    thresh = cm.max() / 2.0 if cm.max() else 0.5
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            if cm[i, j]:
                ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                        color="white" if cm[i, j] > thresh else "black", fontsize=8)
    fig.colorbar(im)
    fig.tight_layout()
    if savefilename:
        fig.savefig(savefilename)
    plt.close(fig)


def _named_leaves(tree, path=()):
    """[(path, leaf)] of a nested dict/list/tuple tree in JAX's flattening
    order: dict keys sorted, sequences in order, ``None`` an empty subtree."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _named_leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _named_leaves(v, path + (i,))]
    return [] if tree is None else [(path, tree)]


def print_network(params, log_fn=print):
    """Dump parameter-tree shapes (the analogue of Lasagne print_network);
    leaves are tensors or numpy arrays."""
    total = 0
    for path, leaf in _named_leaves(params):
        name = "/".join(str(k) for k in path)
        dtype = str(leaf.dtype).replace("torch.", "")
        log_fn(f"  {name}: {tuple(leaf.shape)} {dtype}")
        total += int(np.prod(leaf.shape))
    log_fn(f"  total parameters: {total:,}")
    return total
