"""setup_s: seconds from the start of the process to the start of the window."""


def read(run):
    return None if run.traced else run.setup_s
