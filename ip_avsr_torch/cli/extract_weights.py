"""Weight-surgery CLI: extract encoder / LSTM weights from a saved model.
The port of ip_avsr_tpu/cli/extract_weights.py.

Parity with runners/extract_encoder_from_model.py and
runners/extract_lstm_from_model.py: load pickled model parameters (either
package's ``save_model_params``), pull the named encoder dense layers (saved
as w1..wN/b1..bN) or the named LSTM layers (saved as 12-key bundles,
modelzoo/deltanet_majority_vote.py:158-196) and write them to ``.mat`` for
reuse as pretrained substreams.  Runs on the host.

Usage:
    python -m ip_avsr_torch.cli.extract_weights --model best.pkl \\
        --encoder-stream s1 --out encoder.mat
    python -m ip_avsr_torch.cli.extract_weights --model best.pkl \\
        --lstm streams/s1/lstm:lstm_s1 --out lstms.mat
"""

from __future__ import annotations

import argparse

import numpy as np

from ip_avsr_torch.io import matio
from ip_avsr_torch.models.encoder import _layer_sort_key


def _get_path(params, path):
    node = params
    for part in path.split("/"):
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    return node


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True, help="pickled model params (save_best)")
    ap.add_argument("--out", required=True, help="output .mat")
    ap.add_argument("--encoder-stream",
                    help="stream name whose encoder to export as w1..wN/b1..bN")
    ap.add_argument("--lstm", action="append", default=[],
                    help="pytree-path:prefix pairs, e.g. streams/s1/lstm:lstm_s1; "
                    "repeatable")
    args = ap.parse_args(argv)

    params = matio.load_model_params(args.model)
    out = {}
    if args.encoder_stream:
        streams = params["streams"]
        if args.encoder_stream not in streams:
            ap.error(f"unknown stream '{args.encoder_stream}'; this model has: "
                     f"{sorted(streams)} (zoo configs name streams s1..sN)")
        if "encoder" not in streams[args.encoder_stream]:
            ap.error(f"stream '{args.encoder_stream}' has no encoder")
        enc = streams[args.encoder_stream]["encoder"]
        for i, name in enumerate(sorted(enc.keys(), key=_layer_sort_key), 1):
            out[f"w{i}"] = np.asarray(enc[name]["w"])
            out[f"b{i}"] = np.asarray(enc[name]["b"]).reshape(1, -1)
    for spec in args.lstm:
        path, prefix = spec.split(":")
        out.update(matio.lstm_params_to_mat_dict(_get_path(params, path), prefix))
    if not out:
        ap.error("nothing to extract: pass --encoder-stream and/or --lstm")
    matio.save_mat(out, args.out)
    print(f"wrote {len(out)} arrays to {args.out}")


if __name__ == "__main__":
    main()
