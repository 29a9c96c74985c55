"""One child process, with JAX made unimportable, for the port's tests that
check the port runs without JAX.

Each such test module registers its script when it is imported
(``script(name, code)``); pytest imports every test module before it runs
a test, so the first ``result(name)`` finds them all and runs them one
after another in a single child process, where no CUDA device is visible
and a ``sys.meta_path`` finder refuses every import of ``jax``, ``jaxlib``
or ``benor_tpu`` with ``ImportError`` after it records the attempt.

A script runs in a namespace of its own, from ``tmp`` (a directory of its
own, the working directory while it runs, removed after it; the repo
comes from PYTHONPATH) and with ``loaded(*packages)`` defined: the sorted
names of the modules of those packages that are loaded, and of every
blocked module whose import was attempted, by this script or an earlier
one.  So a guarded optional import (``try: import jax`` / ``except
ImportError``) still shows, as it would have loaded JAX in a process
where JAX can be imported.  ``result`` returns what a script printed and
the traceback it raised, if any.  The child's torch import is paid once a
run instead of once a test.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPTS: dict = {}
_RESULTS: dict = {}

_RUNNER = r'''
import contextlib, io, json, os, shutil, sys, tempfile, traceback

BLOCKED = ("jax", "jaxlib", "benor_tpu")
attempted = set()


class Blocker:
    """Records every attempt to import a module of BLOCKED, then refuses
    it."""

    @staticmethod
    def find_spec(name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            attempted.add(name)
            raise ModuleNotFoundError(f"{name} is blocked", name=name)
        return None


sys.meta_path.insert(0, Blocker)


def loaded(*packages):
    return sorted({m for m in list(sys.modules) + sorted(attempted)
                   if m.split(".")[0] in packages})


scripts = json.loads(sys.stdin.read())
home = os.getcwd()
out = {}
for name, code in scripts.items():
    tmp = tempfile.mkdtemp(prefix="no_jax_")
    os.chdir(tmp)
    buf = io.StringIO()
    error = ""
    try:
        with contextlib.redirect_stdout(buf):
            exec(compile(code, name, "exec"),
                 {"__name__": "__main__", "tmp": tmp, "loaded": loaded})
    except BaseException:
        error = traceback.format_exc()
    os.chdir(home)
    shutil.rmtree(tmp, ignore_errors=True)
    out[name] = [buf.getvalue(), error]
print(json.dumps(out))
'''


def script(name: str, code: str) -> None:
    """Register a script under ``name`` (a test module calls this at
    import)."""
    _SCRIPTS[name] = textwrap.dedent(code)


def result(name: str) -> tuple:
    """(stdout, traceback or '') of the script ``name``: every registered
    script is run in one child process the first time a result is asked
    for (again for a script registered since)."""
    if name not in _RESULTS:
        todo = {k: v for k, v in _SCRIPTS.items() if k not in _RESULTS}
        proc = subprocess.run([sys.executable, "-c", _RUNNER], cwd=ROOT,
                              input=json.dumps(todo), capture_output=True,
                              text=True, timeout=600,
                              env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                                   "PYTHONPATH": os.pathsep.join(
                                       [ROOT] + os.environ.get(
                                           "PYTHONPATH", "").split(
                                               os.pathsep))})
        assert proc.returncode == 0, proc.stderr
        _RESULTS.update({k: tuple(v) for k, v in
                         json.loads(proc.stdout.splitlines()[-1]).items()})
    return _RESULTS[name]
