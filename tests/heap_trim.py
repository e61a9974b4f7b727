"""pytest plugin: hand freed memory back to the system after every test.

One of tests/test_parallel.py's full-size AOT compiles peaks near 20 GiB on
a CPU host, and the process keeps most of it after the test returns: the
compile's objects sit in reference cycles until the next full collection,
and once freed glibc keeps their pages in its malloc arenas (about 12 GiB
after the editor compile).  Under xdist a worker that runs the editor and
remover compiles back to back then peaks near 36 GiB, beside the other
workers' memory.  A full collection and `malloc_trim(0)` after each test
leave each worker holding about what its next test uses.  Both cost about
0.4 s on a worker's heap, so they run only once the process has grown by
GROWTH since the last trim: after every large compile, while a run of small
tests leaves at most GROWTH of garbage behind.

Loaded through `pytest_plugins` by tests/test_torch_port_kernels.py, which
every worker imports at collection.  Only the collection runs where the C
library has no `malloc_trim` (musl, macOS).
"""

import ctypes
import ctypes.util
import gc
import os

import pytest

_LIBC = ctypes.CDLL(ctypes.util.find_library("c") or None)
_TRIM = getattr(_LIBC, "malloc_trim", None)
if _TRIM is not None:
    _TRIM.argtypes = [ctypes.c_size_t]
    _TRIM.restype = ctypes.c_int


GROWTH = 512 * 2 ** 20   # bytes of resident growth that call for a trim
_after_last_trim = None


def trim() -> bool:
    """Return free heap pages to the system; True if any were released."""
    return bool(_TRIM(0)) if _TRIM is not None else False


def resident_bytes():
    """The process's resident set, or None where /proc does not say."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except OSError:
        return None


def due(now, after_last_trim) -> bool:
    """Whether a collection and trim are due: always where the resident
    set is unknown or no trim ran yet, else after GROWTH of growth."""
    return now is None or after_last_trim is None or now - after_last_trim >= GROWTH


@pytest.hookimpl(trylast=True)
def pytest_runtest_teardown(item, nextitem):
    global _after_last_trim
    if due(resident_bytes(), _after_last_trim):
        gc.collect()
        trim()
        _after_last_trim = resident_bytes()
