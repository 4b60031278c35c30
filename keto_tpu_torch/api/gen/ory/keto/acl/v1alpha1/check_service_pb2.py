# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ory/keto/acl/v1alpha1/check_service.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import acl_pb2 as ory_dot_keto_dot_acl_dot_v1alpha1_dot_acl__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\x0a)ory/keto/acl/v1alpha1/check_service.proto\x12\x15ory.keto.acl.v1alpha1\x1a\x1fory/keto/acl/v1alpha1/acl.proto"\x96\x03\x0a\x11\x42\x61tchCheckRequest\x12\x38\x0a\x06tuples\x18\x01 \x03(\x0b\x32(.ory.keto.acl.v1alpha1.CheckRequestTuple\x12\x11\x0a\x09max_depth\x18\x02 \x01(\x05\x12\x11\x0a\x09snaptoken\x18\x03 \x01(\x09\x12\x0e\x0a\x06latest\x18\x04 \x01(\x08\x12\x1e\x0a\x0anamespaces\x18\x05 \x03(\x09R\x0anamespaces\x12\x18\x0a\x07objects\x18\x06 \x03(\x09R\x07objects\x12\x1c\x0a\x09relations\x18\x07 \x03(\x09R\x09relations\x12\x1f\x0a\x0bsubject_ids\x18\x08 \x03(\x09R\x0asubjectIds\x12\x34\x0a\x16subject_set_namespaces\x18\x09 \x03(\x09R\x14subjectSetNamespaces\x12.\x0a\x13subject_set_objects\x18\x0a \x03(\x09R\x11subjectSetObjects\x12\x32\x0a\x15subject_set_relations\x18\x0b \x03(\x09R\x13subjectSetRelations"y\x0a\x11\x43heckRequestTuple\x12\x11\x0a\x09namespace\x18\x01 \x01(\x09\x12\x0e\x0a\x06object\x18\x02 \x01(\x09\x12\x10\x0a\x08relation\x18\x03 \x01(\x09\x12/\x0a\x07subject\x18\x04 \x01(\x0b\x32\x1e.ory.keto.acl.v1alpha1.Subject"8\x0a\x12\x42\x61tchCheckResponse\x12\x0f\x0a\x07\x61llowed\x18\x01 \x03(\x08\x12\x11\x0a\x09snaptoken\x18\x02 \x01(\x09"\xaa\x01\x0a\x0c\x43heckRequest\x12\x11\x0a\x09namespace\x18\x01 \x01(\x09\x12\x0e\x0a\x06object\x18\x02 \x01(\x09\x12\x10\x0a\x08relation\x18\x03 \x01(\x09\x12/\x0a\x07subject\x18\x04 \x01(\x0b\x32\x1e.ory.keto.acl.v1alpha1.Subject\x12\x0e\x0a\x06latest\x18\x05 \x01(\x08\x12\x11\x0a\x09snaptoken\x18\x06 \x01(\x09\x12\x11\x0a\x09max_depth\x18\x07 \x01(\x05"3\x0a\x0d\x43heckResponse\x12\x0f\x0a\x07\x61llowed\x18\x01 \x01(\x08\x12\x11\x0a\x09snaptoken\x18\x02 \x01(\x09\x32\xc5\x01\x0a\x0c\x43heckService\x12R\x0a\x05\x43heck\x12#.ory.keto.acl.v1alpha1.CheckRequest\x1a$.ory.keto.acl.v1alpha1.CheckResponse\x12\x61\x0a\x0a\x42\x61tchCheck\x12(.ory.keto.acl.v1alpha1.BatchCheckRequest\x1a).ory.keto.acl.v1alpha1.BatchCheckResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ory.keto.acl.v1alpha1.check_service_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _BATCHCHECKREQUEST._serialized_start=102
  _BATCHCHECKREQUEST._serialized_end=508
  _CHECKREQUESTTUPLE._serialized_start=510
  _CHECKREQUESTTUPLE._serialized_end=631
  _BATCHCHECKRESPONSE._serialized_start=633
  _BATCHCHECKRESPONSE._serialized_end=689
  _CHECKREQUEST._serialized_start=692
  _CHECKREQUEST._serialized_end=862
  _CHECKRESPONSE._serialized_start=864
  _CHECKRESPONSE._serialized_end=915
  _CHECKSERVICE._serialized_start=918
  _CHECKSERVICE._serialized_end=1115
# @@protoc_insertion_point(module_scope)
