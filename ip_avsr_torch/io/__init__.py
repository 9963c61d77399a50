"""Parameter files of the port (``matio``)."""
