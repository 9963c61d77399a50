"""Inference demo: batch-1 forwards through a trained model (the serve path).

The port of ip_avsr_tpu/cli/demo.py: rebuild the model from an INI config,
restore saved parameters (a pickled numpy tree, as either package's
``save_model_params`` writes it), then classify each utterance and print
the predicted phrase.  Three serving modes:

* sync (default): one forward per utterance;
* ``--streaming``: one ``serve.StreamingSession`` per utterance, fed frame
  by frame (needs a forward-only head: ``use_blstm = false``);
* ``--pipelined``: ``serve.PipelinedServer`` over all utterances, padded to
  one length, ``--depth`` results per copy home, ``--batch`` requests per
  upload.

Runs on ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions).  ``--artifact`` serves an exported program
(``cli.export_model``) in any of the three modes instead of rebuilding the
model; ``--model`` is then not read.

Usage:
    python -m ip_avsr_torch.cli.demo --config configs/synthetic_1stream.ini \\
        --model best.pkl --synthetic 12
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ip_avsr_torch import bridge
from ip_avsr_torch import export as export_lib
from ip_avsr_torch import serve as serve_lib
from ip_avsr_torch.cli import nstream
from ip_avsr_torch.device import resolve_device
from ip_avsr_torch.io import matio
from ip_avsr_torch.models import adenet
from ip_avsr_torch.ops.voting import masked_majority_vote
from ip_avsr_torch.train import config as config_lib

OULU_PHRASES = ["Excuse me", "Goodbye", "Hello", "How are you", "Nice to meet you",
                "See you", "I am sorry", "Thank you", "Have a good time",
                "You are welcome"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--model", help="pickled params (save_model_params of either package)")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--classnames", help="comma-separated class names")
    ap.add_argument("--pipelined", action="store_true",
                    help="serve through serve.PipelinedServer (asynchronous uploads from "
                         "pinned memory, results copied home in blocks of --depth)")
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--batch", type=int, default=1,
                    help="stack up to K queued same-shaped requests into one upload and "
                         "forward (see serve.PipelinedServer)")
    ap.add_argument("--streaming", action="store_true",
                    help="serve each utterance online, frame by frame "
                         "(serve.StreamingSession; scores equal the batch server's with a "
                         "2*window-frame lookahead); needs use_blstm = false")
    ap.add_argument("--artifact", default=None,
                    help="serve from an exported .ipax artifact (cli.export_model) "
                         "instead of rebuilding the model; --model is not read: the "
                         "artifact's weights and traced program do the serving")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.streaming and args.pipelined:
        ap.error("--streaming and --pipelined are mutually exclusive serving modes "
                 "(streaming is per-frame online; pipelined is batched request/response)")
    return args


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cp = config_lib.load_config(args.config)
    stream_cfgs = config_lib.parse_streams(cp)
    clf = config_lib.parse_classifier(cp)
    dims = [s.input_dimensions for s in stream_cfgs]
    # the builder the trainer uses, so a trained model is rebuilt as trained
    cfg = config_lib.build_model_config(stream_cfgs, clf)

    params = artifact = None
    if args.artifact:
        if not args.streaming:
            artifact = export_lib.load_server(args.artifact, device=device)
            if artifact.input_kind != "streams":
                raise SystemExit("demo serves preprocessed streams; the artifact was "
                                 "exported for raw pixels")
    elif args.model:
        params = bridge.params_from_jax(matio.load_model_params(args.model), device=device)
    else:
        print("no --model given: using random init (smoke mode)")
        params = adenet.init_adenet_params(torch.Generator().manual_seed(0), cfg,
                                           device=device)

    if args.classnames:
        classnames = args.classnames.split(",")
    elif clf.output_classnames:
        classnames = clf.output_classnames
    elif clf.output_classes <= len(OULU_PHRASES):
        classnames = OULU_PHRASES[: clf.output_classes]
    else:
        classnames = [str(i) for i in range(clf.output_classes)]

    n = args.synthetic or 5
    data = [nstream.synthesize_dataset(n, d, clf.output_classes, seed=i)
            for i, d in enumerate(dims)]
    lens = data[0]["videoLengthVec"].reshape(-1)
    targets = data[0]["targetsVec"].reshape(-1) - 1
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])

    def utterance(i, T=None):
        """Utterance i's streams, (1, T, D_i) float32, zero-padded to T."""
        L = int(lens[i])
        T = T or L
        return [np.pad(d["dataMatrix"][offsets[i]: offsets[i] + L],
                       ((0, T - L), (0, 0)))[None].astype(np.float32) for d in data]

    def report(i, pred, correct):
        truth = int(targets[offsets[i]])
        ok = pred == truth
        mark = "*" if ok else " "
        print(f"utterance {i + 1:3d}: predicted '{classnames[pred]}' "
              f"(truth '{classnames[truth]}') {mark}")
        return correct + ok

    def decide(probs, mask):
        if probs.ndim == 3:
            return int(masked_majority_vote(probs, mask)[0])
        return int(np.argmax(probs[0]))

    correct = 0
    if args.streaming:
        # one session per utterance, frames fed one by one; the per-frame
        # scores arrive with the 2*window delta lookahead and the final vote
        # equals the batch server's
        if args.artifact:
            # loaded once; each session revives from the same programs
            new_session = export_lib.load_streaming_artifact(args.artifact,
                                                             device=device).new_session
        else:
            new_session = serve_lib.StreamingSession(params, cfg, device=device).fresh
        for i in range(n):
            sess = new_session()
            streams = utterance(i)
            for t in range(int(lens[i])):
                sess.feed([x[:, t: t + 1] for x in streams])
            _, result = sess.finalize()
            pred = (int(result[0]) if cfg.output_mode == "per_step"
                    else int(np.argmax(result[0])))
            correct = report(i, pred, correct)
    elif args.pipelined:
        # requests padded to one T, uploaded asynchronously, results copied
        # home in blocks
        t_max = int(lens.max())
        pipe = serve_lib.PipelinedServer(params, cfg, vote=False, depth=args.depth,
                                         batch=args.batch, serve_fn=artifact, device=device)

        masks = [(np.arange(t_max)[None] < lens[i]).astype(np.float32) for i in range(n)]
        requests = ((utterance(i, t_max), masks[i]) for i in range(n))
        for i, probs in enumerate(pipe.map(requests)):
            correct = report(i, decide(probs, masks[i]), correct)
    else:
        server = artifact or serve_lib.make_server(params, cfg, vote=False, device=device)
        for i in range(n):
            T = int(lens[i])
            probs = server(utterance(i), np.ones((1, T), np.float32)).cpu().numpy()
            correct = report(i, decide(probs, np.ones((1, T))), correct)
    print(f"accuracy: {correct}/{n}")


if __name__ == "__main__":
    main()
