"""Host-side datasets and batch streams of the trainer (numpy only)."""
