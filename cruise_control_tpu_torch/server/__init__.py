"""REST server layer (upstream ``servlet/``; SURVEY.md §2.7)."""

from cruise_control_tpu_torch.server.http_server import (
    BasicSecurityProvider,
    CruiseControlHttpServer,
)
from cruise_control_tpu_torch.server.progress import OperationProgress
from cruise_control_tpu_torch.server.purgatory import Purgatory, ReviewStatus
from cruise_control_tpu_torch.server.user_tasks import (
    TooManyTasksError,
    UserTask,
    UserTaskManager,
    UserTaskState,
)

__all__ = [
    "BasicSecurityProvider", "CruiseControlHttpServer", "OperationProgress",
    "Purgatory", "ReviewStatus", "TooManyTasksError", "UserTask",
    "UserTaskManager", "UserTaskState",
]
