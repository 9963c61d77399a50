"""Host-side helpers: the trainer's, plotting, the model's drawing, ffprobe
(numpy and Python only)."""
