"""gRPC service registration + client stubs without generated service code.

The image ships protobuf codegen (``protoc --python_out``) but not the grpc
plugin, so services are registered via ``grpc.method_handlers_generic_handler``
with explicit (de)serializers — same wire format as generated stubs.

Reference analog: the tonic-generated ``SchedulerGrpc``/``ExecutorGrpc``
services (``ballista.proto:702-744``), with the same RPC names.
"""
from __future__ import annotations

from typing import Any

import grpc

from ballista_tpu_torch.proto import ballista_pb2 as pb

SCHEDULER_SERVICE = "ballista_tpu.SchedulerGrpc"
EXECUTOR_SERVICE = "ballista_tpu.ExecutorGrpc"

SCHEDULER_METHODS: dict[str, tuple[Any, Any]] = {
    "PollWork": (pb.PollWorkParams, pb.PollWorkResult),
    "RegisterExecutor": (pb.RegisterExecutorParams, pb.RegisterExecutorResult),
    "HeartBeatFromExecutor": (pb.HeartBeatParams, pb.HeartBeatResult),
    "UpdateTaskStatus": (pb.UpdateTaskStatusParams, pb.UpdateTaskStatusResult),
    "GetFileMetadata": (pb.GetFileMetadataParams, pb.GetFileMetadataResult),
    "CreateSession": (pb.CreateSessionParams, pb.CreateSessionResult),
    "UpdateSession": (pb.UpdateSessionParams, pb.UpdateSessionResult),
    "RemoveSession": (pb.RemoveSessionParams, pb.RemoveSessionResult),
    "ExecuteQuery": (pb.ExecuteQueryParams, pb.ExecuteQueryResult),
    "GetJobStatus": (pb.GetJobStatusParams, pb.GetJobStatusResult),
    "GetTrace": (pb.GetTraceParams, pb.GetTraceResult),
    # a job's folded counters, JSON in GetTraceResult.trace (the port's own)
    "GetJobMetrics": (pb.GetJobStatusParams, pb.GetTraceResult),
    "ReportTrace": (pb.ReportTraceParams, pb.ReportTraceResult),
    "ExecutorStopped": (pb.ExecutorStoppedParams, pb.ExecutorStoppedResult),
    "CancelJob": (pb.CancelJobParams, pb.CancelJobResult),
    "CleanJobData": (pb.CleanJobDataParams, pb.CleanJobDataResult),
    # pipelined shuffle (docs/shuffle.md): executors poll the live piece feed
    # for pending shuffle pieces of early-resolved consumer stages
    "GetStageInputs": (pb.GetStageInputsParams, pb.GetStageInputsResult),
}

EXECUTOR_METHODS: dict[str, tuple[Any, Any]] = {
    "LaunchMultiTask": (pb.LaunchMultiTaskParams, pb.LaunchMultiTaskResult),
    "StopExecutor": (pb.StopExecutorParams, pb.StopExecutorResult),
    "CancelTasks": (pb.CancelTasksParams, pb.CancelTasksResult),
    "RemoveJobData": (pb.RemoveJobDataParams, pb.RemoveJobDataResult),
}

GRPC_OPTIONS = [
    # reference tuning: 16MB messages, keepalive, nodelay (utils.rs:337-364)
    ("grpc.max_send_message_length", 64 * 1024 * 1024),
    ("grpc.max_receive_message_length", 64 * 1024 * 1024),
    ("grpc.keepalive_time_ms", 20_000),
    ("grpc.keepalive_timeout_ms", 20_000),
]


def add_service(server: grpc.Server, service_name: str, methods: dict, impl: Any) -> None:
    """Register ``impl``'s methods (snake_case) as unary-unary RPC handlers."""
    handlers = {}
    for rpc_name, (req_t, resp_t) in methods.items():
        fn = getattr(impl, _snake(rpc_name))
        handlers[rpc_name] = grpc.unary_unary_rpc_method_handler(
            fn,
            request_deserializer=req_t.FromString,
            response_serializer=resp_t.SerializeToString,
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(service_name, handlers),)
    )


class Stub:
    """Dynamic unary-unary client stub: ``stub.PollWork(params, timeout=...)``."""

    def __init__(self, channel: grpc.Channel, service_name: str, methods: dict):
        for rpc_name, (req_t, resp_t) in methods.items():
            fn = channel.unary_unary(
                f"/{service_name}/{rpc_name}",
                request_serializer=req_t.SerializeToString,
                response_deserializer=resp_t.FromString,
            )
            setattr(self, rpc_name, fn)


def scheduler_stub(addr: str) -> Stub:
    channel = grpc.insecure_channel(addr, options=GRPC_OPTIONS)
    return Stub(channel, SCHEDULER_SERVICE, SCHEDULER_METHODS)


def executor_stub(addr: str) -> Stub:
    channel = grpc.insecure_channel(addr, options=GRPC_OPTIONS)
    return Stub(channel, EXECUTOR_SERVICE, EXECUTOR_METHODS)


def _snake(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)
