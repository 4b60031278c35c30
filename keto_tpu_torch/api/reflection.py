"""gRPC server reflection (grpc.reflection.v1alpha), by hand (counterpart
of ``keto_tpu/api/reflection.py``).

Both gRPC servers register reflection, so ``grpcurl list`` and its kind
work out of the box, as against the reference. No grpcio-reflection
package is needed: this module speaks the streaming protocol over
protobuf's default descriptor pool. ``list_services`` answers the names
registered when the server was built; file lookups resolve transitively (a
client needs a file's whole dependency closure to decode it).
"""

from __future__ import annotations

from typing import Iterable, Iterator

import grpc
from google.protobuf import descriptor_pool

from .gen.reflection import reflection_pb2

SERVICE_NAME = "grpc.reflection.v1alpha.ServerReflection"


def _file_closure(fd, seen: dict):
    """FileDescriptor -> {name: serialized FileDescriptorProto}, transitive."""
    if fd.name in seen:
        return
    seen[fd.name] = fd.serialized_pb
    for dep in fd.dependencies:
        _file_closure(dep, seen)


class ReflectionServicer:
    def __init__(self, service_names: Iterable[str]):
        self._services = tuple(service_names) + (SERVICE_NAME,)
        self._pool = descriptor_pool.Default()

    def _file_response(self, fd):
        seen: dict = {}
        _file_closure(fd, seen)
        return reflection_pb2.ServerReflectionResponse(
            file_descriptor_response=reflection_pb2.FileDescriptorResponse(
                file_descriptor_proto=list(seen.values())
            )
        )

    def _error(self, code: grpc.StatusCode, message: str):
        return reflection_pb2.ServerReflectionResponse(
            error_response=reflection_pb2.ErrorResponse(
                error_code=code.value[0], error_message=message
            )
        )

    def ServerReflectionInfo(self, request_iterator, context) -> Iterator:
        for request in request_iterator:
            kind = request.WhichOneof("message_request")
            if kind == "list_services":
                resp = reflection_pb2.ServerReflectionResponse(
                    list_services_response=reflection_pb2.ListServiceResponse(
                        service=[
                            reflection_pb2.ServiceResponse(name=n)
                            for n in self._services
                        ]
                    )
                )
            elif kind == "file_by_filename":
                try:
                    fd = self._pool.FindFileByName(request.file_by_filename)
                    resp = self._file_response(fd)
                except KeyError:
                    resp = self._error(
                        grpc.StatusCode.NOT_FOUND,
                        f"file not found: {request.file_by_filename}",
                    )
            elif kind == "file_containing_symbol":
                try:
                    fd = self._pool.FindFileContainingSymbol(
                        request.file_containing_symbol
                    )
                    resp = self._file_response(fd)
                except KeyError:
                    resp = self._error(
                        grpc.StatusCode.NOT_FOUND,
                        f"symbol not found: {request.file_containing_symbol}",
                    )
            else:
                resp = self._error(
                    grpc.StatusCode.UNIMPLEMENTED,
                    f"unsupported reflection request: {kind}",
                )
            resp.valid_host = request.host
            resp.original_request.CopyFrom(request)
            yield resp


def add_reflection_service(server, service_names: Iterable[str]) -> None:
    servicer = ReflectionServicer(service_names)
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler(
            SERVICE_NAME,
            {
                "ServerReflectionInfo": grpc.stream_stream_rpc_method_handler(
                    servicer.ServerReflectionInfo,
                    request_deserializer=(
                        reflection_pb2.ServerReflectionRequest.FromString
                    ),
                    response_serializer=(
                        reflection_pb2.ServerReflectionResponse.SerializeToString
                    ),
                ),
            },
        ),
    ))
