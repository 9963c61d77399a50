"""Video playback / inspection utility (parity: oulu/playvid.py:1-21); the
port of ip_avsr_tpu/cli/playvid.py (host-side, no device).

The reference loops over ``s30_v1_u{31..60}.mp4``, half-size-resizes each
frame, converts to grayscale, and shows it in an OpenCV window.  This
version keeps that interactive path (``--show``, q to quit) and adds a
HEADLESS mode for display-less machines (the default): per-video frame
statistics plus an optional grayscale contact-sheet PNG per video
(``--sheet-dir``), which is the useful part of "playing" a video when there
is no screen.

Usage:
    python -m ip_avsr_torch.cli.playvid VIDEO [VIDEO ...]
    python -m ip_avsr_torch.cli.playvid --pattern 'data/s30_v1_u{}.mp4' \
        --start 31 --end 61 --sheet-dir /tmp/sheets
"""

from __future__ import annotations

import argparse
import os


def iter_frames(videofile: str, scale: float = 0.5):
    """Decoded grayscale frames at ``scale``, reference semantics
    (cv2 INTER_LINEAR resize then BGR->GRAY, oulu/playvid.py:13-14)."""
    import cv2

    cap = cv2.VideoCapture(videofile)
    try:
        while cap.isOpened():
            ret, frame = cap.read()
            if not ret:
                break
            frame = cv2.resize(frame, None, fx=scale, fy=scale,
                               interpolation=cv2.INTER_LINEAR)
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    finally:
        cap.release()


def contact_sheet(frames, cols: int = 10):
    """Tile frames (equal shape) into one grayscale image array."""
    import numpy as np

    frames = list(frames)
    if not frames:
        return None
    h, w = frames[0].shape[:2]
    rows = -(-len(frames) // cols)
    sheet = np.zeros((rows * h, cols * w), dtype=frames[0].dtype)
    for i, f in enumerate(frames):
        r, c = divmod(i, cols)
        sheet[r * h : (r + 1) * h, c * w : (c + 1) * w] = f
    return sheet


def play(videofile: str, show: bool, sheet_dir=None, scale: float = 0.5,
         step: int = 1) -> int:
    import cv2

    print(f"video file: {videofile}")
    n = 0
    kept = []
    for i, gray in enumerate(iter_frames(videofile, scale)):
        n += 1
        if sheet_dir is not None and i % step == 0:
            kept.append(gray)  # sheets also collect during interactive play
        if show:
            cv2.imshow("frame", gray)
            if cv2.waitKey(1) & 0xFF == ord("q"):
                break
    if show:
        cv2.destroyAllWindows()
    if kept and sheet_dir is not None:
        os.makedirs(sheet_dir, exist_ok=True)
        out = os.path.join(
            sheet_dir,
            os.path.splitext(os.path.basename(videofile))[0] + ".png")
        cv2.imwrite(out, contact_sheet(kept))
        print(f"  {n} frames -> {out}")
    else:
        print(f"  {n} frames")
    return n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("videos", nargs="*", help="video files to play")
    ap.add_argument("--pattern", help="filename pattern with one {} slot "
                                      "(reference: '../examples/data/s30_v1_u{}.mp4')")
    ap.add_argument("--start", type=int, default=31)
    ap.add_argument("--end", type=int, default=61, help="exclusive")
    ap.add_argument("--show", action="store_true",
                    help="interactive OpenCV window (needs a display; "
                         "q to quit a video)")
    ap.add_argument("--sheet-dir", help="headless: write a contact-sheet PNG "
                                        "per video into this directory")
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument("--step", type=int, default=1,
                    help="keep every Nth frame in the contact sheet")
    options = ap.parse_args(argv)

    videos = list(options.videos)
    if options.pattern:
        videos += [options.pattern.format(i)
                   for i in range(options.start, options.end)]
    if not videos:
        ap.error("no videos given (positional files or --pattern)")
    total = 0
    for v in videos:
        if not os.path.exists(v):
            print(f"video file: {v} (missing, skipped)")
            continue
        total += play(v, options.show, options.sheet_dir, options.scale,
                      options.step)
    print(f"total frames: {total}")


if __name__ == "__main__":
    main()
