"""CPU seconds of the process over the window (every thread), per 10^9
bytes of user data the window moved."""


def read(run):
    if not run.user_bytes:
        return None
    return run.cpu_s / (run.user_bytes / 1e9)
