"""ffprobe-based video frame inspection (offline data pipeline); the port's
copy of ip_avsr_tpu/utils/ffmpeg.py.

Contract parity with utils/ffmpeg.py in the reference: ``ffprobe_video(path)``
returns ``(audio_frames, video_frames)`` where each frame exposes the typed
ffprobe fields (``stream_index``, ``key_frame``, ``pkt_pts``,
``pkt_pts_time``, ..., video: ``width``/``height``/``pict_type``, audio:
``sample_fmt``/``nb_samples``/``channels``) with 'N/A' mapped to -1 (ints) /
NaN (floats).  The frame pts times are what the dataset preparation scripts
use to segment utterances (oulu/prepare_data.py:60-92).

Unlike the reference's strict line-order parser, this one reads each
[FRAME]..[/FRAME] block into a key/value dict, so it tolerates ffprobe
version differences in field order and presence.
"""

from __future__ import annotations

import math
import subprocess
from typing import List, Tuple


_INT_FIELDS = (
    "stream_index", "key_frame", "pkt_pts", "pkt_dts", "best_effort_timestamp",
    "pkt_duration", "pkt_pos", "pkt_size", "width", "height",
    "coded_picture_number", "display_picture_number", "interlaced_frame",
    "top_field_first", "repeat_pict", "nb_samples", "channels",
)
_FLOAT_FIELDS = (
    "pkt_pts_time", "pkt_dts_time", "best_effort_timestamp_time",
    "pkt_duration_time",
)


# ffmpeg >= 5 renamed frame timestamp fields (pkt_pts -> pts,
# pkt_pts_time -> pts_time, pkt_duration -> duration); accept either
# spelling on INPUT and normalize to the legacy pkt_* attribute names the
# reference-era consumers (data/segmentation.py) read.
_FIELD_ALIASES = {
    "pts": "pkt_pts", "pts_time": "pkt_pts_time",
    "dts": "pkt_dts", "dts_time": "pkt_dts_time",
    "duration": "pkt_duration", "duration_time": "pkt_duration_time",
}


class FFProbeFrame:
    """One ffprobe frame; attributes mirror the reference's frame classes."""

    def __init__(self, fields: dict):
        self.media_type = fields.get("media_type", "")
        # typed fields default so segmentation never AttributeErrors on a
        # probe that omits them (ffmpeg version / stream differences)
        for key in _INT_FIELDS:
            setattr(self, key, -1)
        for key in _FLOAT_FIELDS:
            setattr(self, key, math.nan)
        for key, value in fields.items():
            key = _FIELD_ALIASES.get(key, key)
            if key in _INT_FIELDS:
                value = -1 if value == "N/A" else int(value)
            elif key in _FLOAT_FIELDS:
                value = math.nan if value == "N/A" else float(value)
            setattr(self, key, value)

    def __repr__(self):  # pragma: no cover
        return f"<{self.media_type} frame pts_time={getattr(self, 'pkt_pts_time', None)}>"


def parse_ffprobe_output(text: str) -> Tuple[List[FFProbeFrame], List[FFProbeFrame]]:
    audio_frames, video_frames = [], []
    fields: dict = {}
    in_frame = False
    for raw in text.splitlines():
        line = raw.strip()
        if line == "[FRAME]":
            in_frame = True
            fields = {}
        elif line == "[/FRAME]":
            if in_frame:
                frame = FFProbeFrame(fields)
                (video_frames if frame.media_type == "video" else audio_frames).append(frame)
            in_frame = False
        elif in_frame and "=" in line:
            key, value = line.split("=", 1)
            fields.setdefault(key, value)
        # [SIDE_DATA] blocks fall through harmlessly: their keys are merged
        # with setdefault so they never clobber frame fields
    return audio_frames, video_frames


def ffprobe_video(filename: str) -> Tuple[List[FFProbeFrame], List[FFProbeFrame]]:
    """Probe a video; returns (audio_frames, video_frames)."""
    command = ["ffprobe", "-show_frames", filename]
    proc = subprocess.Popen(command, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out, _ = proc.communicate()
    return parse_ffprobe_output(out.decode("utf-8", errors="replace"))
