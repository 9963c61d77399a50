"""Landmark extraction driver: videos -> per-video 68-point landmark CSVs; the
port of ip_avsr_tpu/cli/landmark.py (host-side, no device).

Parity with the three reference drivers in one CLI:
  * landmarking/landmarker.py:115-163 — recursive video discovery, dlib
    frontal detector + 68-pt predictor, one CSV per video (-1 rows when no
    face is found);
  * landmarking/landmarker_omp.py:185-207 — ``--workers N`` multiprocessing
    pool (JoinableQueue + poison pills);
  * oulu/landmarking.py:108-123 — ``--pattern`` glob filtering (e.g.
    's*_v1_u*.mp4' to process only OuluVS frontal-view videos), sorted order.

dlib and OpenCV are optional runtime dependencies; without dlib the CLI
fails with an actionable message unless ``--fake-landmarker`` (testing) is
given.

Usage:
    python -m ip_avsr_torch.cli.landmark --input videos/ --output landmarks/ \
        --predictor shape_predictor_68_face_landmarks.dat --workers 8 \
        --pattern 's*_v1_u*.mp4'
"""

from __future__ import annotations

import argparse
import fnmatch
import os

from ip_avsr_torch.data import landmarking


def _fake_landmarker_factory(_arg):
    """Deterministic stand-in for the dlib fitter (tests / dry runs):
    'detects' a face on every frame with landmarks on a fixed grid."""
    def landmark_fn(frame):
        h = getattr(frame, "shape", (64, 64))[0]
        w = getattr(frame, "shape", (64, 64, 0))[1] if hasattr(frame, "shape") else 64
        return [((i * 7) % max(w, 1), (i * 11) % max(h, 1)) for i in range(68)]
    return landmark_fn


def collect_tasks(input_dir: str, output_dir: str, pattern: str = None,
                  extensions=(".mp4", ".mpg", ".avi")):
    """(video, out_csv) pairs for every video under ``input_dir``, optionally
    filtered by a basename glob, sorted (oulu/landmarking.py:111-112)."""
    videos = sorted(landmarking.find_videos(input_dir, extensions))
    if pattern:
        videos = [v for v in videos if fnmatch.fnmatch(os.path.basename(v), pattern)]
    tasks = []
    for v in videos:
        base = os.path.splitext(os.path.basename(v))[0]
        tasks.append((v, os.path.join(output_dir, base + ".csv")))
    return tasks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input", required=True, help="video directory (recursive)")
    ap.add_argument("--output", required=True, help="directory for landmark CSVs")
    ap.add_argument("--predictor", help="dlib 68-landmark predictor .dat")
    ap.add_argument("--pattern", help="basename glob, e.g. 's*_v1_u*.mp4'")
    ap.add_argument("--workers", type=int, default=0,
                    help="0: in-process; N>0: multiprocessing pool of N")
    ap.add_argument("--fake-landmarker", action="store_true",
                    help="use a deterministic stub instead of dlib (testing)")
    args = ap.parse_args(argv)

    os.makedirs(args.output, exist_ok=True)
    tasks = collect_tasks(args.input, args.output, args.pattern)
    print(f"{len(tasks)} videos to landmark")
    if not tasks:
        return 0

    if args.fake_landmarker:
        factory, factory_arg = _fake_landmarker_factory, None
    else:
        if not args.predictor:
            raise SystemExit("--predictor is required (or --fake-landmarker)")
        factory, factory_arg = landmarking.make_dlib_landmarker, args.predictor

    if args.workers and args.workers > 0:
        landmarking.run_landmark_pool(tasks, factory, factory_arg,
                                      workers=args.workers)
    else:
        landmark_fn = factory(factory_arg)
        for i, (video, out_csv) in enumerate(tasks):
            n = landmarking.process_video(video, out_csv, landmark_fn)
            print(f"[{i + 1}/{len(tasks)}] {os.path.basename(video)}: {n} frames")
    print("All Done!")
    return len(tasks)


if __name__ == "__main__":
    main()
