# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: kv.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x08kv.proto\x12\x0f\x62\x61llista_tpu.kv\"-\n\x0cKvGetRequest\x12\x10\n\x08keyspace\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t\"-\n\rKvGetResponse\x12\r\n\x05\x66ound\x18\x01 \x01(\x08\x12\r\n\x05value\x18\x02 \x01(\x0c\"<\n\x0cKvPutRequest\x12\x10\n\x08keyspace\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\x0c\"0\n\x0fKvDeleteRequest\x12\x10\n\x08keyspace\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t\"\t\n\x07KvEmpty\"!\n\rKvScanRequest\x12\x10\n\x08keyspace\x18\x01 \x01(\t\"$\n\x06KvPair\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c\"8\n\x0eKvScanResponse\x12&\n\x05pairs\x18\x01 \x03(\x0b\x32\x17.ballista_tpu.kv.KvPair\"L\n\rKvLockRequest\x12\x10\n\x08keyspace\x18\x01 \x01(\t\x12\x0b\n\x03key\x18\x02 \x01(\t\x12\r\n\x05owner\x18\x03 \x01(\t\x12\r\n\x05ttl_s\x18\x04 \x01(\x01\"\"\n\x0eKvLockResponse\x12\x10\n\x08\x61\x63quired\x18\x01 \x01(\x08\"\"\n\x0eKvWatchRequest\x12\x10\n\x08keyspace\x18\x01 \x01(\t\"V\n\x07KvEvent\x12\n\n\x02op\x18\x01 \x01(\t\x12\x10\n\x08keyspace\x18\x02 \x01(\t\x12\x0b\n\x03key\x18\x03 \x01(\t\x12\r\n\x05value\x18\x04 \x01(\x0c\x12\x11\n\thas_value\x18\x05 \x01(\x08\x32\xad\x03\n\x07KvStore\x12\x44\n\x03Get\x12\x1d.ballista_tpu.kv.KvGetRequest\x1a\x1e.ballista_tpu.kv.KvGetResponse\x12>\n\x03Put\x12\x1d.ballista_tpu.kv.KvPutRequest\x1a\x18.ballista_tpu.kv.KvEmpty\x12\x44\n\x06\x44\x65lete\x12 .ballista_tpu.kv.KvDeleteRequest\x1a\x18.ballista_tpu.kv.KvEmpty\x12G\n\x04Scan\x12\x1e.ballista_tpu.kv.KvScanRequest\x1a\x1f.ballista_tpu.kv.KvScanResponse\x12G\n\x04Lock\x12\x1e.ballista_tpu.kv.KvLockRequest\x1a\x1f.ballista_tpu.kv.KvLockResponse\x12\x44\n\x05Watch\x12\x1f.ballista_tpu.kv.KvWatchRequest\x1a\x18.ballista_tpu.kv.KvEvent0\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'kv_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _KVGETREQUEST._serialized_start=29
  _KVGETREQUEST._serialized_end=74
  _KVGETRESPONSE._serialized_start=76
  _KVGETRESPONSE._serialized_end=121
  _KVPUTREQUEST._serialized_start=123
  _KVPUTREQUEST._serialized_end=183
  _KVDELETEREQUEST._serialized_start=185
  _KVDELETEREQUEST._serialized_end=233
  _KVEMPTY._serialized_start=235
  _KVEMPTY._serialized_end=244
  _KVSCANREQUEST._serialized_start=246
  _KVSCANREQUEST._serialized_end=279
  _KVPAIR._serialized_start=281
  _KVPAIR._serialized_end=317
  _KVSCANRESPONSE._serialized_start=319
  _KVSCANRESPONSE._serialized_end=375
  _KVLOCKREQUEST._serialized_start=377
  _KVLOCKREQUEST._serialized_end=453
  _KVLOCKRESPONSE._serialized_start=455
  _KVLOCKRESPONSE._serialized_end=489
  _KVWATCHREQUEST._serialized_start=491
  _KVWATCHREQUEST._serialized_end=525
  _KVEVENT._serialized_start=527
  _KVEVENT._serialized_end=613
  _KVSTORE._serialized_start=616
  _KVSTORE._serialized_end=1045
# @@protoc_insertion_point(module_scope)
