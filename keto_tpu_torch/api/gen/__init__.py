"""The generated protobuf modules of the gRPC plane (a copy of
``keto_tpu/api/gen``): the ``ory.keto.acl.v1alpha1`` messages, the
``grpc.health.v1`` health protocol and ``grpc.reflection.v1alpha``.

The reference's copies import one another as top-level ``ory.…`` modules,
with the gen directory appended to ``sys.path``. Here the one such line in
each module is rewritten to a package-relative import, and ``sys.path`` is
left alone: in a process that has loaded the reference too, an absolute
``ory`` import would resolve to the reference's files. Both packages add
the same serialized files to protobuf's default descriptor pool, so they
share one message class per type and their messages interoperate byte for
byte.

Regenerate with protoc from the reference's ``api/proto`` tree, then make
the ``from ory.keto.acl.v1alpha1 import acl_pb2`` lines relative
(``from . import acl_pb2``). Nothing here is imported unless the gRPC plane
is built.
"""
