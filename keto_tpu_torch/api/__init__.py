"""The transports and their port serving (counterpart of ``keto_tpu/api``):
REST on the standard library, and the gRPC plane (``services``,
``convert``, ``interceptors``, ``reflection``, ``grpc_servers`` and the
generated ``gen`` modules) when ``grpc`` and ``google.protobuf`` import.
Importing this package imports neither."""
