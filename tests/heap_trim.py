"""pytest plugin: hand freed memory back to the system after every test.

One of tests/test_parallel.py's full-size AOT compiles peaks near 20 GiB on
a CPU host, and the process keeps most of it after the test returns: the
compile's objects sit in reference cycles until the next full collection,
and once freed glibc keeps their pages in its malloc arenas (about 12 GiB
after the editor compile).  Under xdist a worker that runs the editor and
remover compiles back to back then peaks near 36 GiB, beside the other
workers' memory.  A full collection and `malloc_trim(0)` after each test
leave each worker holding about what its next test uses.

Loaded through `pytest_plugins` by tests/test_torch_port_kernels.py, which
every worker imports at collection.  Only the collection runs where the C
library has no `malloc_trim` (musl, macOS).
"""

import ctypes
import ctypes.util
import gc

import pytest

_LIBC = ctypes.CDLL(ctypes.util.find_library("c") or None)
_TRIM = getattr(_LIBC, "malloc_trim", None)
if _TRIM is not None:
    _TRIM.argtypes = [ctypes.c_size_t]
    _TRIM.restype = ctypes.c_int


def trim() -> bool:
    """Return free heap pages to the system; True if any were released."""
    return bool(_TRIM(0)) if _TRIM is not None else False


@pytest.hookimpl(trylast=True)
def pytest_runtest_teardown(item, nextitem):
    gc.collect()
    trim()
