"""Face landmarking pipeline (offline feature extraction); the port's copy
of ip_avsr_tpu/data/landmarking.py.

Parity with landmarking/landmarker.py and landmarking/landmarker_omp.py:
detect a face per video frame, fit 68-point landmarks, write one CSV row per
frame (x0,y0,...,x67,y67; a row of -1s when no face is found), with a
multiprocessing worker pool for throughput (the reference's only intra-host
parallelism, landmarker_omp.py:82-93,185-207).

The detector/predictor are pluggable: dlib is used when importable
(landmarker.py:43-59 behavior), otherwise construction raises a clear error —
landmarking is an offline data-prep stage on the host, not part of the
model's compute path.
"""

from __future__ import annotations

import csv
import multiprocessing as mp
import os
from typing import Callable, Iterable, List, Optional

N_LANDMARKS = 68


def find_videos(root: str, extensions=(".mp4", ".mpg", ".avi")) -> List[str]:
    """Recursive video discovery (landmarker.py CLI behavior)."""
    out = []
    for dirpath, _, filenames in os.walk(root):
        for name in filenames:
            if name.lower().endswith(extensions):
                out.append(os.path.join(dirpath, name))
    return sorted(out)


def make_dlib_landmarker(predictor_path: str) -> Callable:
    """Returns frame -> 68 (x, y) pairs or None, using dlib (if available)."""
    try:
        import dlib
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "dlib is not available in this environment; pass a custom "
            "landmark_fn to process_video/LandmarkPool instead") from e

    detector = dlib.get_frontal_face_detector()
    predictor = dlib.shape_predictor(predictor_path)

    def landmark_frame(frame):
        dets = detector(frame, 1)
        if len(dets) == 0:
            return None
        shape = predictor(frame, dets[0])
        return [(shape.part(i).x, shape.part(i).y) for i in range(N_LANDMARKS)]

    return landmark_frame


def iter_video_frames(video_path: str) -> Iterable:
    """Yield frames via OpenCV when available (offline-only dependency)."""
    try:
        import cv2
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("OpenCV is not available; supply frames directly") from e
    cap = cv2.VideoCapture(video_path)
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        yield frame
    cap.release()


def landmarks_to_row(landmarks: Optional[list]) -> List[int]:
    """Flatten 68 points to a CSV row; all -1 when detection failed
    (landmarker.py:75-112 convention)."""
    if landmarks is None:
        return [-1] * (2 * N_LANDMARKS)
    row = []
    for x, y in landmarks:
        row.extend([int(x), int(y)])
    return row


def process_video(video_path: str, out_csv: str, landmark_fn: Callable,
                  frames: Optional[Iterable] = None) -> int:
    """Landmark every frame of one video into a CSV; returns frame count."""
    frames = frames if frames is not None else iter_video_frames(video_path)
    count = 0
    with open(out_csv, "w", newline="") as f:
        writer = csv.writer(f)
        for frame in frames:
            writer.writerow(landmarks_to_row(landmark_fn(frame)))
            count += 1
    return count


def _worker(task_queue: "mp.JoinableQueue", landmark_factory, factory_arg):
    """Worker loop: consume (video, out_csv) tasks until a poison pill
    (landmarker_omp.py:82-93 structure)."""
    landmark_fn = landmark_factory(factory_arg)
    while True:
        task = task_queue.get()
        if task is None:  # poison pill
            task_queue.task_done()
            break
        video_path, out_csv = task
        try:
            process_video(video_path, out_csv, landmark_fn)
        except Exception as e:  # pragma: no cover
            print(f"error processing {video_path}: {e}")
        task_queue.task_done()


def run_landmark_pool(tasks: List[tuple], landmark_factory, factory_arg,
                      workers: Optional[int] = None):
    """Multiprocessing pool over (video, out_csv) tasks
    (landmarker_omp.py:185-207: JoinableQueue + poison pills,
    default workers = cpu_count)."""
    workers = workers or mp.cpu_count()
    queue: "mp.JoinableQueue" = mp.JoinableQueue()
    procs = [mp.Process(target=_worker, args=(queue, landmark_factory, factory_arg))
             for _ in range(workers)]
    for p in procs:
        p.start()
    for task in tasks:
        queue.put(task)
    for _ in procs:
        queue.put(None)
    # liveness-checked join: a worker killed by a native crash (dlib/OpenCV
    # segfault on a corrupt frame) never calls task_done for its pending
    # tasks, so a bare queue.join() would hang the whole run forever.  Run
    # the join on a helper thread and watch worker liveness; bail out
    # loudly if a worker dies abnormally.
    import threading

    joined = threading.Event()

    def _join():
        queue.join()
        joined.set()

    waiter = threading.Thread(target=_join, daemon=True)
    waiter.start()
    while not joined.wait(timeout=1.0):
        dead = [p for p in procs
                if not p.is_alive() and p.exitcode not in (0, None)]
        if dead:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            raise RuntimeError(
                f"{len(dead)} landmark worker(s) crashed (exitcodes "
                f"{[p.exitcode for p in dead]}); aborting the pool instead "
                f"of deadlocking on queue.join()")
        if not any(p.is_alive() for p in procs):
            if joined.wait(timeout=1.0):  # workers done AND queue drained:
                break                     # the normal finish racing our poll
            raise RuntimeError(
                "all landmark workers exited with tasks still pending; "
                "aborting instead of hanging")
    for p in procs:
        p.join()
