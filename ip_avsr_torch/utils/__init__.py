"""Host-side helpers of the trainer (numpy and Python only)."""
