"""A time limit for tests of the port's threaded code.

A parameter-server client waits for its reply without a limit and a trainer
joins its worker threads without one, so a dead PS loop or a stuck worker
would hang the whole run. :func:`time_limited` runs a test on a thread and
fails it when it has not ended in time.
"""

import functools
import threading


def time_limited(test=None, *, timeout: float = 120.0):
    """Decorator: run the test on a daemon thread, re-raise what it raises
    or return what it returns, and fail when it is still running after
    ``timeout`` seconds."""
    if test is None:
        return functools.partial(time_limited, timeout=timeout)

    @functools.wraps(test)
    def wrapper(*args, **kwargs):
        out = {}

        def run():
            try:
                out["value"] = test(*args, **kwargs)
            except BaseException as e:  # re-raised on the test's thread
                out["error"] = e

        t = threading.Thread(target=run, name=f"time-limited-{test.__name__}", daemon=True)
        t.start()
        t.join(timeout)
        assert not t.is_alive(), f"{test.__name__} did not end within {timeout} s"
        if "error" in out:
            raise out["error"]
        return out.get("value")

    return wrapper
