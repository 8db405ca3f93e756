"""priority — order tasks and jobs by descending priority.

ref: pkg/scheduler/plugins/priority/priority.go.
"""
from __future__ import annotations

from ..api import JobInfo, TaskInfo
from ..framework import Plugin, Session

NAME = "priority"


class PriorityPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    @property
    def name(self) -> str:
        return NAME

    def on_session_open(self, ssn: Session) -> None:
        def task_order_fn(l: TaskInfo, r: TaskInfo) -> int:
            if l.priority == r.priority:
                return 0
            return -1 if l.priority > r.priority else 1

        ssn.add_task_order_fn(NAME, task_order_fn)

        def job_order_fn(l: JobInfo, r: JobInfo) -> int:
            if l.priority > r.priority:
                return -1
            if l.priority < r.priority:
                return 1
            return 0

        ssn.add_job_order_fn(NAME, job_order_fn)


def new(arguments=None) -> PriorityPlugin:
    return PriorityPlugin(arguments)
