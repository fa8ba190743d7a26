# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: flight_sql.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x10\x66light_sql.proto\x12\x19\x61rrow.flight.protocol.sql\"V\n\x15\x43ommandStatementQuery\x12\r\n\x05query\x18\x01 \x01(\t\x12\x1b\n\x0etransaction_id\x18\x02 \x01(\x0cH\x00\x88\x01\x01\x42\x11\n\x0f_transaction_id\"0\n\x14TicketStatementQuery\x12\x18\n\x10statement_handle\x18\x01 \x01(\x0c\"B\n\x1d\x43ommandPreparedStatementQuery\x12!\n\x19prepared_statement_handle\x18\x01 \x01(\x0c\"e\n$ActionCreatePreparedStatementRequest\x12\r\n\x05query\x18\x01 \x01(\t\x12\x1b\n\x0etransaction_id\x18\x02 \x01(\x0cH\x00\x88\x01\x01\x42\x11\n\x0f_transaction_id\"z\n#ActionCreatePreparedStatementResult\x12!\n\x19prepared_statement_handle\x18\x01 \x01(\x0c\x12\x16\n\x0e\x64\x61taset_schema\x18\x02 \x01(\x0c\x12\x18\n\x10parameter_schema\x18\x03 \x01(\x0c\"H\n#ActionClosePreparedStatementRequest\x12!\n\x19prepared_statement_handle\x18\x01 \x01(\x0c\"\x14\n\x12\x43ommandGetCatalogs\"{\n\x13\x43ommandGetDbSchemas\x12\x14\n\x07\x63\x61talog\x18\x01 \x01(\tH\x00\x88\x01\x01\x12%\n\x18\x64\x62_schema_filter_pattern\x18\x02 \x01(\tH\x01\x88\x01\x01\x42\n\n\x08_catalogB\x1b\n\x19_db_schema_filter_pattern\"\xeb\x01\n\x10\x43ommandGetTables\x12\x14\n\x07\x63\x61talog\x18\x01 \x01(\tH\x00\x88\x01\x01\x12%\n\x18\x64\x62_schema_filter_pattern\x18\x02 \x01(\tH\x01\x88\x01\x01\x12&\n\x19table_name_filter_pattern\x18\x03 \x01(\tH\x02\x88\x01\x01\x12\x13\n\x0btable_types\x18\x04 \x03(\t\x12\x16\n\x0einclude_schema\x18\x05 \x01(\x08\x42\n\n\x08_catalogB\x1b\n\x19_db_schema_filter_patternB\x1c\n\x1a_table_name_filter_pattern\"\x16\n\x14\x43ommandGetTableTypes\"!\n\x11\x43ommandGetSqlInfo\x12\x0c\n\x04info\x18\x01 \x03(\r\"n\n\x15\x43ommandGetPrimaryKeys\x12\x14\n\x07\x63\x61talog\x18\x01 \x01(\tH\x00\x88\x01\x01\x12\x16\n\tdb_schema\x18\x02 \x01(\tH\x01\x88\x01\x01\x12\r\n\x05table\x18\x03 \x01(\tB\n\n\x08_catalogB\x0c\n\n_db_schema\"o\n\x16\x43ommandGetExportedKeys\x12\x14\n\x07\x63\x61talog\x18\x01 \x01(\tH\x00\x88\x01\x01\x12\x16\n\tdb_schema\x18\x02 \x01(\tH\x01\x88\x01\x01\x12\r\n\x05table\x18\x03 \x01(\tB\n\n\x08_catalogB\x0c\n\n_db_schema\"o\n\x16\x43ommandGetImportedKeys\x12\x14\n\x07\x63\x61talog\x18\x01 \x01(\tH\x00\x88\x01\x01\x12\x16\n\tdb_schema\x18\x02 \x01(\tH\x01\x88\x01\x01\x12\r\n\x05table\x18\x03 \x01(\tB\n\n\x08_catalogB\x0c\n\n_db_schema\">\n\x16\x43ommandGetXdbcTypeInfo\x12\x16\n\tdata_type\x18\x01 \x01(\x05H\x00\x88\x01\x01\x42\x0c\n\n_data_typeb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'flight_sql_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _COMMANDSTATEMENTQUERY._serialized_start=47
  _COMMANDSTATEMENTQUERY._serialized_end=133
  _TICKETSTATEMENTQUERY._serialized_start=135
  _TICKETSTATEMENTQUERY._serialized_end=183
  _COMMANDPREPAREDSTATEMENTQUERY._serialized_start=185
  _COMMANDPREPAREDSTATEMENTQUERY._serialized_end=251
  _ACTIONCREATEPREPAREDSTATEMENTREQUEST._serialized_start=253
  _ACTIONCREATEPREPAREDSTATEMENTREQUEST._serialized_end=354
  _ACTIONCREATEPREPAREDSTATEMENTRESULT._serialized_start=356
  _ACTIONCREATEPREPAREDSTATEMENTRESULT._serialized_end=478
  _ACTIONCLOSEPREPAREDSTATEMENTREQUEST._serialized_start=480
  _ACTIONCLOSEPREPAREDSTATEMENTREQUEST._serialized_end=552
  _COMMANDGETCATALOGS._serialized_start=554
  _COMMANDGETCATALOGS._serialized_end=574
  _COMMANDGETDBSCHEMAS._serialized_start=576
  _COMMANDGETDBSCHEMAS._serialized_end=699
  _COMMANDGETTABLES._serialized_start=702
  _COMMANDGETTABLES._serialized_end=937
  _COMMANDGETTABLETYPES._serialized_start=939
  _COMMANDGETTABLETYPES._serialized_end=961
  _COMMANDGETSQLINFO._serialized_start=963
  _COMMANDGETSQLINFO._serialized_end=996
  _COMMANDGETPRIMARYKEYS._serialized_start=998
  _COMMANDGETPRIMARYKEYS._serialized_end=1108
  _COMMANDGETEXPORTEDKEYS._serialized_start=1110
  _COMMANDGETEXPORTEDKEYS._serialized_end=1221
  _COMMANDGETIMPORTEDKEYS._serialized_start=1223
  _COMMANDGETIMPORTEDKEYS._serialized_end=1334
  _COMMANDGETXDBCTYPEINFO._serialized_start=1336
  _COMMANDGETXDBCTYPEINFO._serialized_end=1398
# @@protoc_insertion_point(module_scope)
