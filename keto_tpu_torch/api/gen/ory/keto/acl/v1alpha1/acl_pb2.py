# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ory/keto/acl/v1alpha1/acl.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1fory/keto/acl/v1alpha1/acl.proto\x12\x15ory.keto.acl.v1alpha1\"u\n\rRelationTuple\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\x0e\n\x06object\x18\x02 \x01(\t\x12\x10\n\x08relation\x18\x03 \x01(\t\x12/\n\x07subject\x18\x04 \x01(\x0b\x32\x1e.ory.keto.acl.v1alpha1.Subject\"P\n\x07Subject\x12\x0c\n\x02id\x18\x01 \x01(\tH\x00\x12\x30\n\x03set\x18\x02 \x01(\x0b\x32!.ory.keto.acl.v1alpha1.SubjectSetH\x00\x42\x05\n\x03ref\"A\n\nSubjectSet\x12\x11\n\tnamespace\x18\x01 \x01(\t\x12\x0e\n\x06object\x18\x02 \x01(\t\x12\x10\n\x08relation\x18\x03 \x01(\tb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ory.keto.acl.v1alpha1.acl_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _RELATIONTUPLE._serialized_start=58
  _RELATIONTUPLE._serialized_end=175
  _SUBJECT._serialized_start=177
  _SUBJECT._serialized_end=257
  _SUBJECTSET._serialized_start=259
  _SUBJECTSET._serialized_end=324
# @@protoc_insertion_point(module_scope)
