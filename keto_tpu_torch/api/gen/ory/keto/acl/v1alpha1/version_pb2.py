# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ory/keto/acl/v1alpha1/version.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n#ory/keto/acl/v1alpha1/version.proto\x12\x15ory.keto.acl.v1alpha1\"\x13\n\x11GetVersionRequest\"%\n\x12GetVersionResponse\x12\x0f\n\x07version\x18\x01 \x01(\t2s\n\x0eVersionService\x12\x61\n\nGetVersion\x12(.ory.keto.acl.v1alpha1.GetVersionRequest\x1a).ory.keto.acl.v1alpha1.GetVersionResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ory.keto.acl.v1alpha1.version_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _GETVERSIONREQUEST._serialized_start=62
  _GETVERSIONREQUEST._serialized_end=81
  _GETVERSIONRESPONSE._serialized_start=83
  _GETVERSIONRESPONSE._serialized_end=120
  _VERSIONSERVICE._serialized_start=122
  _VERSIONSERVICE._serialized_end=237
# @@protoc_insertion_point(module_scope)
