"""kasa_tpu's native library, loaded in every test worker.

kasa_tpu builds `_kasa_loader.so` in place with `g++ -o` at first use
(kasa_tpu/native/__init__.py), and tests/test_native_writer.py calls
get_lib() at import.  Under pytest-xdist every worker collects that
module at the same moment, so on a checkout without the library all of
them build it at once; a worker that opens the file while another is
still writing it gets None, remembers the failure for its whole life,
and every later test of that worker that holds the port to kasa_tpu's
fast path compares against another engine.

This module is collected after test_native_writer.py and before any
test runs.  Its module-level code loads the library again in a worker
where the first load failed: one worker at a time (an fcntl lock in the
temp directory), retrying every 2 s for up to 90 s while another worker
may still be writing the file.  kasa_tpu itself stays as it is.
"""

import fcntl
import os
import tempfile
import time

import kasa_tpu.native as _ref_native

RETRY_S = 2.0
WAIT_S = 90.0


def _reload_reference_native():
    if _ref_native._lib is not None:
        return
    lock = os.path.join(tempfile.gettempdir(), "kasa_tpu_native_build.lock")
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            deadline = time.monotonic() + WAIT_S
            while _ref_native._lib is None:
                _ref_native._tried = False
                try:
                    _ref_native.get_lib()
                except Exception:       # a half-written file: retry
                    _ref_native._lib = None
                if _ref_native._lib is not None \
                        or time.monotonic() > deadline:
                    break
                time.sleep(RETRY_S)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


_reload_reference_native()


def test_reference_native_library_loads():
    assert _ref_native.get_lib() is not None
