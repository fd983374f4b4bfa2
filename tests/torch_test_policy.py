"""The thread policy and the time limit of the port's tests.

A test module of the port takes both with

    from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

pytest finds fixtures among a module's names, and both fixtures are autouse.

Thread policy.  The CPUs this process may run on are shared by the xdist
workers: while a module runs, torch's intra-op pool has `THREADS` of them, at
least one.  The gloo ranks of the multi-rank tests take one thread each
(`run_world(..., threads=1)`).

Time limit.  A test has `TIME_LIMIT_S` seconds from the start of its set-up
(its module's fixtures included, for the module's first test) to the start of
the next test's set-up, or to the end of its module's tear-down.  A test that
runs over fails: the processes started under its limit are killed, every
thread's stack is printed, and `pytest.fail` is raised where the main thread
stands.  If the main thread does not come back into Python within
`HARD_GRACE_S` more (it may sit in native code), a watchdog thread prints the
stacks to the process's stderr, kills those processes and ends the process.
xdist reports that as a failure of the test and hands the rest of its file to
a new worker, where they fail at once: their module's fixtures would hang the
same way.

Imports no JAX: the card runs the gpu test files with --noconftest.
"""

import contextlib
import faulthandler
import hashlib
import os
import signal
import sys
import tempfile
import threading

import pytest
import torch

# seconds a test may take, as above: three times the port's longest test
# (test_torch_node_in_field.py::test_node_in_field_accepts_its_children with
# its module's set-up, 248 s beside the suite's five other xdist workers on an
# 8-core CPU, two of them in XLA:CPU all run long)
TIME_LIMIT_S = 750.0
# seconds after the limit before a process whose main thread has not come
# back into Python is ended
HARD_GRACE_S = 60.0


def _cpus() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


THREADS = max(1, _cpus() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


def _children(pid: int) -> list:
    """The processes whose parent is `pid` (from /proc)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(d))
    return out


def _descendants() -> set:
    found, todo = set(), [os.getpid()]
    while todo:
        for c in _children(todo.pop()):
            if c not in found:
                found.add(c)
                todo.append(c)
    return found


def _kill(pids) -> None:
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass


class _Limit:
    """One test's limit: SIGALRM in the main thread at `TIME_LIMIT_S`, and a
    watchdog thread that ends the process `HARD_GRACE_S` later."""

    def __init__(self, nodeid: str, ended_file, stderr_fd: int):
        self.nodeid, self.ended_file, self.stderr_fd = nodeid, ended_file, stderr_fd
        self.from_module_setup = False
        self.before = _descendants()
        self.done = threading.Event()
        self.old = signal.signal(signal.SIGALRM, self._on_alarm)
        signal.setitimer(signal.ITIMER_REAL, TIME_LIMIT_S)
        threading.Thread(target=self._watchdog, name="time-limit", daemon=True).start()

    def stop(self) -> None:
        self.done.set()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, self.old)

    def _started(self) -> set:
        return _descendants() - self.before

    def _on_alarm(self, signum, frame):
        _kill(self._started())
        sys.stderr.write(f"\n{self.nodeid} ran past its time limit of {TIME_LIMIT_S:.0f} s; "
                         "the stacks of every thread:\n")
        sys.stderr.flush()
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        pytest.fail(f"{self.nodeid} ran past its time limit of {TIME_LIMIT_S:.0f} s")

    def _watchdog(self):
        if self.done.wait(TIME_LIMIT_S + HARD_GRACE_S):
            return
        _kill(self._started())
        with os.fdopen(os.dup(self.stderr_fd), "w") as err:
            err.write(f"\n{self.nodeid} ran past its time limit of {TIME_LIMIT_S:.0f} s and "
                      f"did not stop {HARD_GRACE_S:.0f} s later; the stacks of every thread, "
                      "then this process exits:\n")
            err.flush()
            faulthandler.dump_traceback(file=err, all_threads=True)
        if self.ended_file:
            open(self.ended_file, "w").close()
        os._exit(1)


_armed = None       # the _Limit running now, if any
_stderr_fd = None   # the process's own stderr, for the watchdog's stacks


def _disarm() -> None:
    global _armed
    if _armed is not None:
        _armed.stop()
        _armed = None


def _arm(request, nodeid: str) -> "_Limit":
    global _armed, _stderr_fd
    _disarm()
    if _stderr_fd is None:
        # pytest's capture replaces fd 2 while tests run
        capman = request.config.pluginmanager.getplugin("capturemanager")
        with capman.global_and_fixture_disabled() if capman else contextlib.nullcontext():
            _stderr_fd = os.dup(2)
    _armed = _Limit(nodeid, _ended_file(request), _stderr_fd)
    return _armed


def _ended_file(request):
    """The file that marks the module as having ended an xdist worker of this
    run (None outside xdist)."""
    run = getattr(request.config, "workerinput", {}).get("testrunuid")
    if run is None:
        return None
    name = hashlib.sha256(str(request.path).encode()).hexdigest()[:32]
    return os.path.join(tempfile.gettempdir(), f"time_limit_{run}_{name}")


@pytest.fixture(autouse=True, scope="module")
def policy_per_module(request):
    """The module's torch threads, and the first test's limit from the start
    of the module's set-up; at the end of its tear-down, no limit."""
    ended = _ended_file(request)
    if ended and os.path.exists(ended):
        pytest.fail(f"a test of {request.path.name} ended its worker at its time limit")
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    _arm(request, f"the set-up of {request.path.name}").from_module_setup = True
    yield
    _disarm()
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def policy_per_test(request):
    """Each test's limit: the module's, if the test set the module up, else
    a new one."""
    if _armed is not None and _armed.from_module_setup:
        _armed.nodeid, _armed.from_module_setup = request.node.nodeid, False
    else:
        _arm(request, request.node.nodeid)
