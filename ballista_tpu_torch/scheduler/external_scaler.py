"""KEDA external scaler: k8s autoscaling signal for executors.

Reference analog: ``ExternalScaler`` impl
(``arrow-ballista: ballista/scheduler/src/scheduler_server/external_scaler.rs:38-56``):
``IsActive`` when any job is pending/running; metric = inflight task/job
pressure so KEDA scales executor replicas up and down.

It closes the autoscaling loop (docs/elasticity.md): the pressure math comes from
the shared :mod:`ballista_tpu_torch.scheduler.scale` signal — queued task-slots
(incl. speculatable backups) + running attempts + admission-queue depth —
and a second metric, ``desired_executors`` (target 1), exposes the
ScaleController's clamp'd fleet target directly, so a KEDA ScaledObject can
follow the controller's policy (hysteresis, occupancy target, min/max)
instead of re-deriving it from raw pressure. Capacity-side facts
(quarantined/terminating executors take no new tasks) shape
``desired_executors``; tasks stranded on a quarantined executor still count
toward pressure — they are exactly the backlog a new replica relieves.
"""
from __future__ import annotations

import grpc

from ballista_tpu_torch.proto import keda_pb2 as kpb
from ballista_tpu_torch.proto.rpc import add_service

KEDA_SERVICE = "externalscaler.ExternalScaler"
INFLIGHT_METRIC = "inflight_tasks"
DESIRED_METRIC = "desired_executors"
DEFAULT_TARGET = 4  # tasks per executor replica


KEDA_METHODS = {
    "IsActive": (kpb.ScaledObjectRef, kpb.IsActiveResponse),
    "GetMetricSpec": (kpb.ScaledObjectRef, kpb.GetMetricSpecResponse),
    "GetMetrics": (kpb.GetMetricsRequest, kpb.GetMetricsResponse),
}


class ExternalScalerService:
    def __init__(self, scheduler):
        self.scheduler = scheduler

    def _signal(self):
        ctl = getattr(self.scheduler, "scale", None)
        if ctl is not None:
            return ctl.signal()
        from ballista_tpu_torch.scheduler.scale import compute_signal

        return compute_signal(self.scheduler)

    def is_active(self, req: kpb.ScaledObjectRef, ctx) -> kpb.IsActiveResponse:
        return kpb.IsActiveResponse(result=self._signal().pressure > 0)

    def get_metric_spec(self, req: kpb.ScaledObjectRef, ctx) -> kpb.GetMetricSpecResponse:
        target = int(req.scalerMetadata.get("tasksPerReplica", DEFAULT_TARGET))
        specs = [
            kpb.MetricSpec(metricName=INFLIGHT_METRIC, targetSize=target),
            # replicas = metric/target, so target 1 makes KEDA track the
            # controller's desired fleet size one-to-one
            kpb.MetricSpec(metricName=DESIRED_METRIC, targetSize=1),
        ]
        # the helm chart's keda.metricName selects ONE driving metric: KEDA
        # scales on the max over every ADVERTISED spec, so advertising both
        # when the operator chose loose inflight packing would let
        # desired_executors silently override it
        want = req.scalerMetadata.get("metricName", "")
        if want:
            chosen = [s for s in specs if s.metricName == want]
            if chosen:
                specs = chosen
            else:
                # fail open (both advertised) but LOUDLY: a typo'd selection
                # silently co-driving replicas is the hazard the filter
                # exists to prevent
                import logging

                logging.getLogger("ballista.scheduler.scale").warning(
                    "unknown KEDA metricName %r (valid: %s, %s); advertising "
                    "both metrics", want, INFLIGHT_METRIC, DESIRED_METRIC,
                )
        return kpb.GetMetricSpecResponse(metricSpecs=specs)

    def get_metrics(self, req: kpb.GetMetricsRequest, ctx) -> kpb.GetMetricsResponse:
        sig = self._signal()
        values = {
            INFLIGHT_METRIC: sig.pressure,
            DESIRED_METRIC: sig.desired_executors,
        }
        # KEDA asks for one metric at a time; an empty name gets both
        want = req.metricName
        return kpb.GetMetricsResponse(
            metricValues=[
                kpb.MetricValue(metricName=name, metricValue=v)
                for name, v in values.items()
                if not want or want == name
            ]
        )


def add_external_scaler(server: grpc.Server, scheduler) -> None:
    add_service(server, KEDA_SERVICE, KEDA_METHODS, ExternalScalerService(scheduler))
