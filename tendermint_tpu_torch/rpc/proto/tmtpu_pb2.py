# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tmtpu.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0btmtpu.proto\x12\x0etendermint_tpu\"\xa6\x01\n\x08TxResult\x12\x0c\n\x04\x63ode\x18\x01 \x01(\r\x12\x0c\n\x04\x64\x61ta\x18\x02 \x01(\x0c\x12\x0b\n\x03log\x18\x03 \x01(\t\x12\x30\n\x04tags\x18\x04 \x03(\x0b\x32\".tendermint_tpu.TxResult.TagsEntry\x12\x12\n\ngas_wanted\x18\x05 \x01(\x03\x1a+\n\tTagsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"0\n\x0fValidatorUpdate\x12\x0e\n\x06pubkey\x18\x01 \x01(\x0c\x12\r\n\x05power\x18\x02 \x01(\x03\"\r\n\x0bPingRequest\"\x0e\n\x0cPingResponse\" \n\x12\x42roadcastTxRequest\x12\n\n\x02tx\x18\x01 \x01(\x0c\"\x8d\x01\n\x13\x42roadcastTxResponse\x12*\n\x08\x63heck_tx\x18\x01 \x01(\x0b\x32\x18.tendermint_tpu.TxResult\x12,\n\ndeliver_tx\x18\x02 \x01(\x0b\x32\x18.tendermint_tpu.TxResult\x12\x0c\n\x04hash\x18\x03 \x01(\x0c\x12\x0e\n\x06height\x18\x04 \x01(\x03\"\x1a\n\x0b\x45\x63hoRequest\x12\x0b\n\x03msg\x18\x01 \x01(\t\"\x1b\n\x0c\x45\x63hoResponse\x12\x0b\n\x03msg\x18\x01 \x01(\t\"\r\n\x0bInfoRequest\"e\n\x0cInfoResponse\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\x12\x19\n\x11last_block_height\x18\x03 \x01(\x03\x12\x1b\n\x13last_block_app_hash\x18\x04 \x01(\x0c\".\n\x10SetOptionRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\" \n\x11SetOptionResponse\x12\x0b\n\x03log\x18\x01 \x01(\t\"I\n\x0cQueryRequest\x12\x0c\n\x04path\x18\x01 \x01(\t\x12\x0c\n\x04\x64\x61ta\x18\x02 \x01(\x0c\x12\x0e\n\x06height\x18\x03 \x01(\x03\x12\r\n\x05prove\x18\x04 \x01(\x08\"e\n\rQueryResponse\x12\x0c\n\x04\x63ode\x18\x01 \x01(\r\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\r\n\x05value\x18\x03 \x01(\x0c\x12\r\n\x05proof\x18\x04 \x01(\x0c\x12\x0e\n\x06height\x18\x05 \x01(\x03\x12\x0b\n\x03log\x18\x06 \x01(\t\"\x1c\n\x0e\x43heckTxRequest\x12\n\n\x02tx\x18\x01 \x01(\x0c\"q\n\x10InitChainRequest\x12\x33\n\nvalidators\x18\x01 \x03(\x0b\x32\x1f.tendermint_tpu.ValidatorUpdate\x12\x10\n\x08\x63hain_id\x18\x02 \x01(\t\x12\x16\n\x0e\x61pp_state_json\x18\x03 \x01(\x0c\"\x13\n\x11InitChainResponse\"c\n\x11\x42\x65ginBlockRequest\x12\x0c\n\x04hash\x18\x01 \x01(\x0c\x12\x13\n\x0bheader_json\x18\x02 \x01(\x0c\x12\x16\n\x0e\x62yzantine_json\x18\x03 \x01(\x0c\x12\x13\n\x0b\x61\x62sent_json\x18\x04 \x01(\x0c\"\x14\n\x12\x42\x65ginBlockResponse\"\x1e\n\x10\x44\x65liverTxRequest\x12\n\n\x02tx\x18\x01 \x01(\x0c\"$\n\x15\x44\x65liverTxBatchRequest\x12\x0b\n\x03txs\x18\x01 \x03(\x0c\"C\n\x16\x44\x65liverTxBatchResponse\x12)\n\x07results\x18\x01 \x03(\x0b\x32\x18.tendermint_tpu.TxResult\"!\n\x0f\x45ndBlockRequest\x12\x0e\n\x06height\x18\x01 \x01(\x03\"\xdb\x01\n\x10\x45ndBlockResponse\x12:\n\x11validator_updates\x18\x01 \x03(\x0b\x32\x1f.tendermint_tpu.ValidatorUpdate\x12$\n\x1c\x63onsensus_param_updates_json\x18\x02 \x01(\x0c\x12\x38\n\x04tags\x18\x03 \x03(\x0b\x32*.tendermint_tpu.EndBlockResponse.TagsEntry\x1a+\n\tTagsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\x0f\n\rCommitRequest\"\x1e\n\x0e\x43ommitResponse\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x32\xa9\x01\n\x0c\x42roadcastAPI\x12\x41\n\x04Ping\x12\x1b.tendermint_tpu.PingRequest\x1a\x1c.tendermint_tpu.PingResponse\x12V\n\x0b\x42roadcastTx\x12\".tendermint_tpu.BroadcastTxRequest\x1a#.tendermint_tpu.BroadcastTxResponse2\xdd\x06\n\x0f\x41\x42\x43IApplication\x12\x41\n\x04\x45\x63ho\x12\x1b.tendermint_tpu.EchoRequest\x1a\x1c.tendermint_tpu.EchoResponse\x12\x41\n\x04Info\x12\x1b.tendermint_tpu.InfoRequest\x1a\x1c.tendermint_tpu.InfoResponse\x12P\n\tSetOption\x12 .tendermint_tpu.SetOptionRequest\x1a!.tendermint_tpu.SetOptionResponse\x12\x44\n\x05Query\x12\x1c.tendermint_tpu.QueryRequest\x1a\x1d.tendermint_tpu.QueryResponse\x12\x43\n\x07\x43heckTx\x12\x1e.tendermint_tpu.CheckTxRequest\x1a\x18.tendermint_tpu.TxResult\x12P\n\tInitChain\x12 .tendermint_tpu.InitChainRequest\x1a!.tendermint_tpu.InitChainResponse\x12S\n\nBeginBlock\x12!.tendermint_tpu.BeginBlockRequest\x1a\".tendermint_tpu.BeginBlockResponse\x12G\n\tDeliverTx\x12 .tendermint_tpu.DeliverTxRequest\x1a\x18.tendermint_tpu.TxResult\x12_\n\x0e\x44\x65liverTxBatch\x12%.tendermint_tpu.DeliverTxBatchRequest\x1a&.tendermint_tpu.DeliverTxBatchResponse\x12M\n\x08\x45ndBlock\x12\x1f.tendermint_tpu.EndBlockRequest\x1a .tendermint_tpu.EndBlockResponse\x12G\n\x06\x43ommit\x12\x1d.tendermint_tpu.CommitRequest\x1a\x1e.tendermint_tpu.CommitResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tmtpu_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TXRESULT_TAGSENTRY._options = None
  _TXRESULT_TAGSENTRY._serialized_options = b'8\001'
  _ENDBLOCKRESPONSE_TAGSENTRY._options = None
  _ENDBLOCKRESPONSE_TAGSENTRY._serialized_options = b'8\001'
  _TXRESULT._serialized_start=32
  _TXRESULT._serialized_end=198
  _TXRESULT_TAGSENTRY._serialized_start=155
  _TXRESULT_TAGSENTRY._serialized_end=198
  _VALIDATORUPDATE._serialized_start=200
  _VALIDATORUPDATE._serialized_end=248
  _PINGREQUEST._serialized_start=250
  _PINGREQUEST._serialized_end=263
  _PINGRESPONSE._serialized_start=265
  _PINGRESPONSE._serialized_end=279
  _BROADCASTTXREQUEST._serialized_start=281
  _BROADCASTTXREQUEST._serialized_end=313
  _BROADCASTTXRESPONSE._serialized_start=316
  _BROADCASTTXRESPONSE._serialized_end=457
  _ECHOREQUEST._serialized_start=459
  _ECHOREQUEST._serialized_end=485
  _ECHORESPONSE._serialized_start=487
  _ECHORESPONSE._serialized_end=514
  _INFOREQUEST._serialized_start=516
  _INFOREQUEST._serialized_end=529
  _INFORESPONSE._serialized_start=531
  _INFORESPONSE._serialized_end=632
  _SETOPTIONREQUEST._serialized_start=634
  _SETOPTIONREQUEST._serialized_end=680
  _SETOPTIONRESPONSE._serialized_start=682
  _SETOPTIONRESPONSE._serialized_end=714
  _QUERYREQUEST._serialized_start=716
  _QUERYREQUEST._serialized_end=789
  _QUERYRESPONSE._serialized_start=791
  _QUERYRESPONSE._serialized_end=892
  _CHECKTXREQUEST._serialized_start=894
  _CHECKTXREQUEST._serialized_end=922
  _INITCHAINREQUEST._serialized_start=924
  _INITCHAINREQUEST._serialized_end=1037
  _INITCHAINRESPONSE._serialized_start=1039
  _INITCHAINRESPONSE._serialized_end=1058
  _BEGINBLOCKREQUEST._serialized_start=1060
  _BEGINBLOCKREQUEST._serialized_end=1159
  _BEGINBLOCKRESPONSE._serialized_start=1161
  _BEGINBLOCKRESPONSE._serialized_end=1181
  _DELIVERTXREQUEST._serialized_start=1183
  _DELIVERTXREQUEST._serialized_end=1213
  _DELIVERTXBATCHREQUEST._serialized_start=1215
  _DELIVERTXBATCHREQUEST._serialized_end=1251
  _DELIVERTXBATCHRESPONSE._serialized_start=1253
  _DELIVERTXBATCHRESPONSE._serialized_end=1320
  _ENDBLOCKREQUEST._serialized_start=1322
  _ENDBLOCKREQUEST._serialized_end=1355
  _ENDBLOCKRESPONSE._serialized_start=1358
  _ENDBLOCKRESPONSE._serialized_end=1577
  _ENDBLOCKRESPONSE_TAGSENTRY._serialized_start=155
  _ENDBLOCKRESPONSE_TAGSENTRY._serialized_end=198
  _COMMITREQUEST._serialized_start=1579
  _COMMITREQUEST._serialized_end=1594
  _COMMITRESPONSE._serialized_start=1596
  _COMMITRESPONSE._serialized_end=1626
  _BROADCASTAPI._serialized_start=1629
  _BROADCASTAPI._serialized_end=1798
  _ABCIAPPLICATION._serialized_start=1801
  _ABCIAPPLICATION._serialized_end=2662
# @@protoc_insertion_point(module_scope)
