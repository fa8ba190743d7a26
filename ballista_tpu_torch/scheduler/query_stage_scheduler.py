"""Job lifecycle event processing.

Reference analog: ``QueryStageScheduler``
(``arrow-ballista: ballista/scheduler/src/scheduler_server/
query_stage_scheduler.rs:78-343``): the event-loop brain handling
JobQueued/JobSubmitted/JobFinished/JobRunningFailed/JobCancel/JobDataClean/
TaskUpdating/ReviveOffers. Here the hot task-update path stays inline in the
gRPC handlers (single-writer via locks); this loop owns the *lifecycle* side:
metrics events, delayed job-data cleanup on executors
(``finished_job_data_clean_up_interval_seconds``), and push-mode revive kicks.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field

from ballista_tpu_torch.utils.event_loop import EventAction, EventLoop

log = logging.getLogger("ballista.scheduler.events")


@dataclass(frozen=True)
class JobQueued:
    job_id: str


@dataclass(frozen=True)
class JobSubmitted:
    job_id: str


@dataclass(frozen=True)
class JobFinished:
    job_id: str
    at: float = field(default_factory=time.time)


@dataclass(frozen=True)
class JobRunningFailed:
    job_id: str
    error: str


@dataclass(frozen=True)
class JobCancel:
    job_id: str


@dataclass(frozen=True)
class JobDataClean:
    job_id: str


@dataclass(frozen=True)
class ReviveOffers:
    pass


class QueryStageScheduler(EventAction):
    def __init__(self, server, clean_up_interval_s: float = 300.0):
        self.server = server
        self.clean_up_interval_s = clean_up_interval_s
        self.loop = EventLoop(
            "query-stage", self, buffer_size=10_000, expected_processing_s=0.5
        )

    def start(self):
        self.loop.start()

    def post(self, event) -> None:
        self.loop.post(event, timeout=1.0)

    def on_receive(self, event) -> None:
        from ballista_tpu_torch.proto import ballista_pb2 as pb

        if isinstance(event, JobFinished):
            # delayed shuffle-data cleanup on all executors (reference:
            # clean_up_job_data_delayed, task_manager.rs:690-703)
            def later():
                time.sleep(self.clean_up_interval_s)
                self.post(JobDataClean(event.job_id))

            threading.Thread(
                target=later, daemon=True, name="expiry-job-data"
            ).start()
        elif isinstance(event, JobDataClean):
            self.server.clean_job_data(pb.CleanJobDataParams(job_id=event.job_id), None)
            log.info("cleaned job data for %s", event.job_id)
        elif isinstance(event, JobCancel):
            self.server.cancel_job(pb.CancelJobParams(job_id=event.job_id), None)
        elif isinstance(event, ReviveOffers):
            if self.server.config.scheduling_policy == "push":
                self.server.revive_offers()
        elif isinstance(event, (JobQueued, JobSubmitted, JobRunningFailed)):
            log.debug("lifecycle event %r", event)
