"""The gRPC half of the port's serving (counterpart of the gRPC half of
``keto_tpu/api/daemon.py``): the read and write planes' gRPC servers with
the reference's service sets.

``api/daemon.py`` puts each server behind its plane's public port, which
answers REST and gRPC alike. Only the registry imports this module, and
only when ``grpc`` and ``google.protobuf`` import (without them the
planes serve REST alone).
"""

from __future__ import annotations

from concurrent import futures

import grpc

from .interceptors import TelemetryInterceptor
from .reflection import add_reflection_service
from .services import (
    _PKG,
    CheckServicer,
    ExpandServicer,
    HealthServicer,
    ListServicer,
    ReadServicer,
    VersionServicer,
    WriteServicer,
    add_check_service,
    add_expand_service,
    add_health_service,
    add_list_service,
    add_read_service,
    add_version_service,
    add_write_service,
)

_HEALTH = "grpc.health.v1.Health"
READ_SERVICES = (
    f"{_PKG}.CheckService",
    f"{_PKG}.ExpandService",
    f"{_PKG}.ReadService",
    f"{_PKG}.VersionService",
    _HEALTH,
)
WRITE_SERVICES = (
    f"{_PKG}.WriteService",
    f"{_PKG}.VersionService",
    _HEALTH,
)


def grpc_message_options(max_message_bytes: int) -> list:
    """Channel and server options lifting grpc's 4 MiB message cap
    (columnar BatchCheck payloads pass it); 0 keeps grpc's defaults.
    Servers and clients share them so both ends agree."""
    if not max_message_bytes:
        return []
    return [
        ("grpc.max_receive_message_length", int(max_message_bytes)),
        ("grpc.max_send_message_length", int(max_message_bytes)),
    ]


def _server(
    plane: str, max_workers: int, max_message_bytes: int,
    logger=None, metrics=None, tracer=None,
) -> grpc.Server:
    executor = futures.ThreadPoolExecutor(
        max_workers=max_workers, thread_name_prefix=f"keto-grpc-{plane}"
    )
    server = grpc.server(
        executor,
        interceptors=(TelemetryInterceptor(plane, logger, metrics, tracer),),
        options=grpc_message_options(max_message_bytes),
    )
    server._keto_executor = executor  # shut down by PlaneServer.stop
    return server


def build_read_grpc_server(
    checker,
    expand_engine,
    manager,
    snaptoken_fn,
    version: str,
    health: HealthServicer,
    max_workers: int = 32,
    max_message_bytes: int = 0,
    max_freshness_wait_s=30.0,
    encoded_front=None,  # the id-native wire tier (api/encoded.py), or None
    list_engine=None,  # reverse-index list serving (engine/listing.py), or None
    list_version_waiter=None,  # the list service's snaptoken gate
    default_criticality: str = "default",  # overload.default_criticality
    logger=None,
    metrics=None,
    tracer=None,
    telemetry=None,  # the check telemetry (telemetry/flight.CheckTelemetry)
    replication_waiter=None,  # a follower's snaptoken gate, or None
) -> grpc.Server:
    """Read-plane gRPC: Check, Expand, Read, Version, Health and reflection,
    plus List when the reverse-index tier is on."""
    server = _server("read", max_workers, max_message_bytes, logger, metrics, tracer)
    add_check_service(
        server,
        CheckServicer(
            checker, snaptoken_fn, max_freshness_wait_s=max_freshness_wait_s,
            encoded_front=encoded_front, default_criticality=default_criticality,
            telemetry=telemetry, replication_waiter=replication_waiter,
        ),
    )
    add_expand_service(server, ExpandServicer(
        expand_engine, replication_waiter, max_freshness_wait_s))
    add_read_service(server, ReadServicer(
        manager, replication_waiter, max_freshness_wait_s))
    services = READ_SERVICES
    if list_engine is not None:
        add_list_service(
            server,
            ListServicer(
                list_engine, snaptoken_fn, version_waiter=list_version_waiter,
                max_freshness_wait_s=max_freshness_wait_s, telemetry=telemetry,
                replication_waiter=replication_waiter,
            ),
        )
        services = services + (f"{_PKG}.ListService",)
    add_version_service(server, VersionServicer(version))
    add_health_service(server, health)
    add_reflection_service(server, services)
    return server


def build_write_grpc_server(
    manager,
    snaptoken_fn,
    version: str,
    health: HealthServicer,
    max_workers: int = 32,
    max_message_bytes: int = 0,
    logger=None,
    metrics=None,
    tracer=None,
    read_only=False,  # a bool, or a callable asked per mutation
) -> grpc.Server:
    """Write-plane gRPC: Write, Version, Health and reflection."""
    server = _server("write", max_workers, max_message_bytes, logger, metrics, tracer)
    add_write_service(server, WriteServicer(manager, snaptoken_fn, read_only=read_only))
    add_version_service(server, VersionServicer(version))
    add_health_service(server, health)
    add_reflection_service(server, WRITE_SERVICES)
    return server
