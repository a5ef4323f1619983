"""The JAX package's native library (native/libmatfac_native.so) as a test
reference, made loadable whatever other test processes are doing.

The library is not in git: the first process that asks for it runs
``make -C native`` (matfac_tpu/utils/native.py) and remembers a failure
for the rest of the process. Under pytest-xdist several workers do so at
once, and one that finds a half-written file keeps ``None``, after which
JAX's ``item_cosine_sim`` takes its numpy route, whose tie rule differs.
``load_native_ref`` serialises the build under a file lock in ``build/``,
forgets a failure remembered from such a race, and waits a bounded time
for the library to load; when it never loads it raises, naming why.
Nothing of the JAX package is edited: only its module's memo is reset.
"""

import ctypes
import fcntl
import os
import subprocess
import time

from matfac_tpu.utils import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(ROOT, "native")
LIBRARY = os.path.join(NATIVE_DIR, "libmatfac_native.so")
LOCK = os.path.join(ROOT, "build", "native_ref.lock")
WAIT_S = 120.0


def _why_not() -> str:
    if not os.path.exists(LIBRARY):
        return f"{LIBRARY} does not exist"
    try:
        ctypes.CDLL(LIBRARY)
    except OSError as e:
        return f"{LIBRARY} does not load: {e}"
    return f"{LIBRARY} loads, but the JAX package's _find_lib gives None"


def load_native_ref():
    """The JAX package's loaded library (its ``native._find_lib()``),
    building it under the lock if the file is missing; RuntimeError if it
    does not load within WAIT_S seconds."""
    os.makedirs(os.path.dirname(LOCK), exist_ok=True)
    deadline = time.monotonic() + WAIT_S
    made = ""
    with open(LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            while True:
                lib = native._find_lib()
                if lib is not None:
                    return lib
                native._TRIED = False   # forget a failure from a race
                if not os.path.exists(LIBRARY):
                    proc = subprocess.run(
                        ["make", "-C", NATIVE_DIR], capture_output=True,
                        text=True, timeout=WAIT_S)
                    made = (f"make -C native exited {proc.returncode}:\n"
                            f"{proc.stdout}{proc.stderr}")
                lib = native._find_lib()
                if lib is not None:
                    return lib
                native._TRIED = False
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        "the JAX package's native library, the reference "
                        f"of these tests, did not load in {WAIT_S:.0f} s: "
                        f"{_why_not()}\n{made}")
                time.sleep(0.5)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
