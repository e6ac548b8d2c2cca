"""Host-side job coordinator for benchmark/sweep orchestration.

The reference's distributed/ package (DistributedCoordinator coordinator.py:79,
ClusterManager cluster_manager.py:171, LoadBalancer load_balancer.py:63) is an
in-process task-queue simulation that never serves the solve path (SURVEY
§2.6). The multi-host JAX runtime replaces all of it for *solving*;
what remains genuinely useful is a thin host-side runner that schedules many
independent jobs (benchmark grids, seed sweeps, hyperparameter scans) with
retries, heartbeat-style progress, and result collection — so that is what
this is."""

from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional


class JobStatus(Enum):
    PENDING = "pending"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"


@dataclass
class Job:
    job_id: str
    fn: Callable[[], Any]
    max_retries: int = 2
    status: JobStatus = JobStatus.PENDING
    result: Any = None
    error: Optional[str] = None
    attempts: int = 0
    submitted_at: float = field(default_factory=time.time)
    finished_at: Optional[float] = None


class JobCoordinator:
    """Worker-thread pool with retry + progress accounting.

    Device work inside jobs is serialized by JAX itself; the thread pool
    overlaps host-side phases (encode, IO) with device execution. Use
    n_workers=1 for strictly ordered device jobs."""

    def __init__(self, n_workers: int = 2):
        self.n_workers = n_workers
        self.jobs: Dict[str, Job] = {}
        self._queue: "queue.Queue[str]" = queue.Queue()
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "JobCoordinator":
        if self._threads:
            return self
        self._stop.clear()
        for i in range(self.n_workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"sgt-worker-{i}")
            t.start()
            self._threads.append(t)
        return self

    def shutdown(self, wait: bool = True) -> None:
        if wait:
            self._queue.join()
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()

    # -- submission ---------------------------------------------------------

    def submit(self, job_id: str, fn: Callable[[], Any],
               max_retries: int = 2) -> Job:
        job = Job(job_id=job_id, fn=fn, max_retries=max_retries)
        with self._lock:
            if job_id in self.jobs:
                raise ValueError(f"duplicate job id {job_id!r}")
            self.jobs[job_id] = job
        self._queue.put(job_id)
        return job

    def map(self, fn: Callable[[Any], Any], items: List[Any],
            prefix: str = "job") -> List[str]:
        ids = []
        for i, item in enumerate(items):
            jid = f"{prefix}_{i}"
            self.submit(jid, (lambda item=item: fn(item)))
            ids.append(jid)
        return ids

    # -- execution ----------------------------------------------------------

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                job_id = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            job = self.jobs[job_id]
            job.status = JobStatus.RUNNING
            try:
                job.attempts += 1
                job.result = job.fn()
                job.status = JobStatus.COMPLETED
            except Exception:
                job.error = traceback.format_exc(limit=4)
                if job.attempts <= job.max_retries:
                    job.status = JobStatus.PENDING
                    self._queue.put(job_id)
                else:
                    job.status = JobStatus.FAILED
            finally:
                job.finished_at = time.time()
                self._queue.task_done()

    # -- results ------------------------------------------------------------

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until all submitted jobs settle. Returns True if none failed."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            with self._lock:
                pending = [j for j in self.jobs.values()
                           if j.status in (JobStatus.PENDING,
                                           JobStatus.RUNNING)]
            if not pending:
                break
            if deadline and time.time() > deadline:
                return False
            time.sleep(0.05)
        return all(j.status == JobStatus.COMPLETED
                   for j in self.jobs.values())

    def results(self) -> Dict[str, Any]:
        return {jid: j.result for jid, j in self.jobs.items()
                if j.status == JobStatus.COMPLETED}

    def progress(self) -> dict:
        counts: Dict[str, int] = {}
        for j in self.jobs.values():
            counts[j.status.value] = counts.get(j.status.value, 0) + 1
        return counts
