"""Shared pieces of the port's scale-out tests (tests/test_torch_scale_*.py).

Each of those files starts one pool of gloo ranks for the module
(``ip_avsr_torch.utils.cpu_mesh.RankPool``) and sends it the rank bodies of
``ip_avsr_torch.parallel._multiprocess_worker``, so the spawned ranks import
neither a test module nor JAX.  The oracles run here, in the test process:
the port on one process, and the JAX package on the 8 virtual CPU devices
that tests/conftest.py provisions.  Parameters come from the JAX package's
init, as numpy trees that both packages read.
"""

import jax
import numpy as np
import torch

from ip_avsr_torch.utils.cpu_mesh import RankPool

# a pool's task deadline and its group's collective timeout (seconds): a rank
# that hangs fails its test within these, far inside the tier-1 limit
TASK_TIMEOUT_S = 90.0
GROUP_TIMEOUT_S = 30.0


def pool(n):
    """A module's pool of ``n`` gloo ranks."""
    return RankPool(n, backend="gloo", timeout_s=TASK_TIMEOUT_S, group_timeout_s=GROUP_TIMEOUT_S)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def leaves(tree):
    """(path, array) pairs of a nested dict/list tree, in a fixed order."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out.append(("/".join(path), np.asarray(node)))

    walk(tree, ())
    return out


def assert_trees_close(got, ref, atol, rtol=0.0, what=""):
    g, r = leaves(got), leaves(ref)
    assert [p for p, _ in g] == [p for p, _ in r], what
    for (path, a), (_, b) in zip(g, r):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=f"{what} {path}")


def ragged_batch(B, T, dims, classes, seed, min_len=1):
    """Seeded streams (B, T, D_i), int32 labels and a ragged mask with a
    full-length row and a length-``min_len`` row."""
    rng = np.random.RandomState(seed)
    streams = [rng.randn(B, T, d).astype(np.float32) for d in dims]
    lens = rng.randint(min_len, T + 1, B)
    lens[0], lens[-1] = T, min_len
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    y = rng.randint(0, classes, B).astype(np.int32)
    return streams, y, mask


def torch_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.as_tensor(np.array(a)), tree)
