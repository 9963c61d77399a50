"""Mutation fuzz of the port's native ``.mat`` reader (ip_avsr_torch/native).

Run as its own process by tests/test_torch_native_matio.py, so that a crash
of the C++ parser fails that test instead of killing the pytest worker:

    python tests/torch_matread_fuzz.py N_EXAMPLES

Hypothesis (``derandomize=True``: the same mutants on every run) flips
bytes in, truncates and splices garbage into two valid files (compressed
and not).  Contract for every mutant, as for the JAX package's reader:
the process never crashes; the reader returns a dict, or ``None`` (the
file goes to scipy); and where both it and ``scipy.io.loadmat`` parse the
mutant, they agree on names, dtypes, shapes and bytes.  Prints the count of
mutants in each outcome and exits 0 when the contract held.
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import scipy.io as sio  # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from ip_avsr_torch import native  # noqa: E402


def seed_files(tmp):
    """Two valid files of the dataset schema, uncompressed and compressed."""
    rng = np.random.RandomState(0)
    base = {
        "dataMatrix": rng.randn(40, 30).astype(np.float32),
        "targetsVec": rng.randint(0, 10, (40, 1)).astype(np.int32),
        "u8": rng.randint(0, 255, (8, 9)).astype(np.uint8),
        "small": np.array([[3.5]]),
    }
    blobs = []
    for compress in (False, True):
        p = os.path.join(tmp, f"seed_{int(compress)}.mat")
        sio.savemat(p, base, do_compression=compress)
        with open(p, "rb") as f:
            blobs.append(f.read())
    return blobs


@st.composite
def mutants(draw, blobs):
    buf = bytearray(blobs[draw(st.integers(0, len(blobs) - 1))])
    kind = draw(st.sampled_from(["flip", "truncate", "splice"]))
    if kind == "flip":
        for _ in range(draw(st.integers(1, 8))):
            buf[draw(st.integers(0, len(buf) - 1))] = draw(st.integers(0, 255))
    elif kind == "truncate":
        buf = buf[: draw(st.integers(1, len(buf) - 1))]
    else:
        off = draw(st.integers(0, len(buf) - 1))
        span = draw(st.integers(1, min(64, len(buf) - off)))
        buf[off: off + span] = draw(st.binary(min_size=span, max_size=span))
    return bytes(buf)


def outcome(path):
    """Parse with both readers; the bucket of the outcome, or raise where the
    two disagree."""
    got = native.load_mat_native(path)
    if got is None:
        return "native_fallback"
    try:
        ref = sio.loadmat(path)
    except Exception:  # scipy's many error types for a damaged file
        return "native_only"
    ref = {k: v for k, v in ref.items() if not k.startswith("__")}
    got = {k: v for k, v in got.items() if not k.startswith("__")}
    if set(got) != set(ref):
        raise AssertionError(f"names diverge: {sorted(got)} vs {sorted(ref)}")
    for k in got:
        a, b = got[k], ref[k]
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f"key {k}: native {a.dtype}{a.shape} != scipy "
                                 f"{b.dtype}{b.shape} or the bytes differ")
    return "both_parse_equal"


def main(n):
    buckets = {}
    with tempfile.TemporaryDirectory() as tmp:
        blobs = seed_files(tmp)
        path = os.path.join(tmp, "mutant.mat")

        @settings(max_examples=n, derandomize=True, database=None, deadline=None,
                  suppress_health_check=list(HealthCheck))
        @given(mutants(blobs))
        def check(blob):
            with open(path, "wb") as f:
                f.write(blob)
            tag = outcome(path)
            buckets[tag] = buckets.get(tag, 0) + 1

        check()
    total = sum(buckets.values())
    print(f"fuzzed {total} mutants: "
          + ", ".join(f"{k}={v}" for k, v in sorted(buckets.items())))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 200)
