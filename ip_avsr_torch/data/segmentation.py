"""Utterance segmentation from HTK label files + ffprobe frame timing; the
port's copy of ip_avsr_tpu/data/segmentation.py.

Parity with oulu/prepare_data.py:11-92: parse '#Normal' section HTK labels
(start/end in 100ns units + spoken-word label), map words to digits, and
select the video frames whose pts fall inside each utterance window.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

DIGIT_MAP = {"zero": 0, "one": 1, "two": 2, "three": 3, "four": 4,
             "five": 5, "six": 6, "seven": 7, "eight": 8, "nine": 9}


def parse_htk_labels(filename: str) -> List[Tuple[int, int, str]]:
    """Read the '#Normal' block of an HTK label file; times in 100ns units."""
    labels = []
    with open(filename) as f:
        first = f.readline()
        if "Normal" not in first:
            return labels
        for line in f:
            if "#Moving" in line:
                break
            parts = line.strip().split(" ")
            if len(parts) != 3:
                continue
            start, end, word = parts
            labels.append((int(start), int(end), word))
    return labels


def to_100ns(time_in_sec: float) -> int:
    return int(time_in_sec * 10_000_000)


def digit_to_int(word: str) -> int:
    return DIGIT_MAP[word]


def segment_frames(frame_pts_times: Sequence[float],
                   htk_labels: Sequence[Tuple[int, int, str]]):
    """Assign frames to utterance windows.

    frame_pts_times: per-frame presentation times in seconds (from
    utils.ffmpeg.ffprobe_video video frames' pkt_pts_time).
    Returns (frame_idxs, frame_labels, seq_lens) where a frame at time t is
    in the window iff ``start < t*1e7 <= end`` (reference inequality,
    oulu/prepare_data.py:78-88).
    """
    idxs, labels, seq_lens = [], [], []
    current = 0
    n = len(frame_pts_times)
    for start, end, word in htk_labels:
        if word not in DIGIT_MAP:
            # silence/garbage entries ('sil', ...) in the #Normal block:
            # skip the window — its frames are consumed by the next
            # window's leading scan — rather than emitting a STRING label
            # into an otherwise-integer target vector (the reference hard
            # KeyErrors here, oulu/prepare_data.py:58)
            print(f"segment_frames: skipping non-digit label '{word}' "
                  f"({start}-{end})")
            continue
        number = DIGIT_MAP[word]
        seq_len = 0
        while current < n:
            t = to_100ns(frame_pts_times[current])
            if start < t <= end:
                idxs.append(current)
                labels.append(number)
                seq_len += 1
                current += 1
            elif t > end:
                break
            else:
                current += 1
        seq_lens.append(seq_len)
    return idxs, labels, seq_lens


def segment_video(video_file: str, label_file: str):
    """ffprobe + HTK-label segmentation of one video (oulu/prepare_data.py:60-92)."""
    from ip_avsr_torch.utils.ffmpeg import ffprobe_video

    _, video_frames = ffprobe_video(video_file)
    htk_labels = parse_htk_labels(label_file)
    pts = [f.pkt_pts_time for f in video_frames]
    return segment_frames(pts, htk_labels)
