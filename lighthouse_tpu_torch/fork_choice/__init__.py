"""Fork choice: proto-array LMD-GHOST + spec wrapper.

Counterparts of ``consensus/proto_array`` and ``consensus/fork_choice``
(``consensus/{proto_array,fork_choice}/``).
"""

from .device_proto_array import DeviceProtoArrayForkChoice
from .fork_choice import ForkChoice, ForkChoiceError
from .proto_array import (
    EXEC_INVALID,
    EXEC_IRRELEVANT,
    EXEC_OPTIMISTIC,
    EXEC_VALID,
    ProtoArrayError,
    ProtoArrayForkChoice,
)

__all__ = [
    "ForkChoice", "ForkChoiceError", "ProtoArrayForkChoice",
    "DeviceProtoArrayForkChoice",
    "ProtoArrayError", "EXEC_VALID", "EXEC_OPTIMISTIC", "EXEC_INVALID",
    "EXEC_IRRELEVANT",
]
