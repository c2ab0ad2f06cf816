"""Run a function on W ranks, each its own process in one process group.

``run_ranks(fn, world, args)`` starts ``world`` Python processes. Each joins
a process group that meets through a file in a fresh temporary directory
(``file://``: no port to pick, so many such groups can run side by side),
calls ``fn(*args)`` and sends back what it returned; the caller gets the
list in rank order. ``fn`` is a module-level function (of a module, or of
the script run as ``__main__``); ``args`` and the results are pickled,
through files in that directory, which this module alone writes and reads.

The run has one time limit. A rank that raises, or dies, ends the run: the
other ranks are killed (they would wait in their next collective) and the
error names the rank, with its traceback and the end of its output. Past the
limit every rank is killed and ``TimeoutError`` is raised. Each rank has
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set as torchrun sets them.

    python -m audio_few_shot_learning_tpu_torch.parallel.spawn <dir> <rank>

is a rank's own entry point; ``run_ranks`` starts it.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
POLL_S = 0.05
TAIL_CHARS = 4000


def _target(fn: Callable) -> dict:
    if fn.__module__ == "__main__":  # a function of the script being run
        return {"path": os.path.abspath(sys.modules["__main__"].__file__), "name": fn.__qualname__}
    return {"module": fn.__module__, "name": fn.__qualname__}


def _resolve(target: dict) -> Callable:
    if "module" in target:
        module = importlib.import_module(target["module"])
    else:
        spec = importlib.util.spec_from_file_location("__rank_main__", target["path"])
        module = importlib.util.module_from_spec(spec)
        sys.modules["__rank_main__"] = module
        spec.loader.exec_module(module)  # its __main__ block does not run
    return getattr(module, target["name"])


def _tail(path: str) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-TAIL_CHARS:]
    except OSError:
        return ""


def run_ranks(
    fn: Callable,
    world: int,
    args: Sequence[Any] = (),
    backend: str = "gloo",
    timeout_s: float = 120.0,
    threads: Optional[int] = None,
) -> List[Any]:
    """``fn(*args)`` on ranks 0..world-1 in a ``backend`` process group;
    the values they return, in rank order. ``threads`` sets each rank's
    CPU threads (``torch.set_num_threads``)."""
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        with open(os.path.join(tmp, "job.pkl"), "wb") as f:
            pickle.dump(dict(target=_target(fn), args=tuple(args), world=world, backend=backend,
                             init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                             timeout_s=timeout_s, threads=threads, sys_path=list(sys.path)), f)
        env = dict(os.environ, WORLD_SIZE=str(world),
                   PYTHONPATH=os.pathsep.join([REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        if threads is not None:
            env["OMP_NUM_THREADS"] = str(threads)
        procs = []
        try:
            for rank in range(world):
                log = open(os.path.join(tmp, f"rank{rank}.log"), "wb")
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "audio_few_shot_learning_tpu_torch.parallel.spawn", tmp, str(rank)],
                    env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)), stdout=log, stderr=subprocess.STDOUT,
                ))
                log.close()
            deadline = time.monotonic() + timeout_s
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if failed:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__qualname__} ran past {timeout_s} s; "
                                       f"rank 0's output:\n{_tail(os.path.join(tmp, 'rank0.log'))}")
                time.sleep(POLL_S)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outcomes = []
        for rank in range(world):
            out = os.path.join(tmp, f"result{rank}.pkl")
            outcomes.append(None)
            if os.path.exists(out):
                with open(out, "rb") as f:
                    outcomes[rank] = pickle.load(f)
        # the rank that raised, else one that died; the others were killed after it
        raised = [r for r, o in enumerate(outcomes) if o is not None and "error" in o]
        died = [r for r, o in enumerate(outcomes) if o is None]
        for rank in raised or died:
            why = outcomes[rank]["error"] if rank in raised else f"exit code {procs[rank].returncode}"
            raise RuntimeError(f"rank {rank} of {world} ({fn.__qualname__}) failed: {why}\n"
                               f"its output:\n{_tail(os.path.join(tmp, f'rank{rank}.log'))}")
        return [o["value"] for o in outcomes]


def _child(tmp: str, rank: int) -> int:
    with open(os.path.join(tmp, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    sys.path[:0] = [p for p in job["sys_path"] if p not in sys.path]
    out = os.path.join(tmp, f"result{rank}.pkl")
    try:
        import torch
        import torch.distributed as dist

        from audio_few_shot_learning_tpu_torch.parallel.mesh import maybe_initialize_distributed

        if job["threads"] is not None:
            torch.set_num_threads(job["threads"])
        maybe_initialize_distributed(job["init_method"], job["world"], rank, job["backend"], job["timeout_s"])
        outcome = {"value": _resolve(job["target"])(*job["args"])}
    except BaseException:  # reported to the launcher, which raises it
        outcome = {"error": traceback.format_exc()}
    with open(out + ".tmp", "wb") as f:
        pickle.dump(outcome, f)
    os.replace(out + ".tmp", out)
    if "error" in outcome:
        os._exit(1)  # the other ranks may never join a teardown
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1], int(sys.argv[2])))
