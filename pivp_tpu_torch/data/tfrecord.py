"""Dependency-free TFRecord reader/writer and tf.train.Example wire-format
parser/encoder.

The port's own copy of `pivp_tpu/data/tfrecord.py`. It replaces the
reference's TF1 queue-runner ingestion (make_dataset.py:35-93:
string_input_producer -> TFRecordReader -> parse_single_example) with a
streaming parser: no TensorFlow session, no threads, no graph.
`read_records` frames a shard with the native scanner
(csrc/tfrecord_index.cc through data/native.py, built at first use);
`read_records_plain` is its pure-Python plain version.

TFRecord framing (per record):
  uint64  length
  uint32  masked_crc32c(length)
  bytes   data[length]
  uint32  masked_crc32c(data)

tf.train.Example protobuf subset parsed here:
  Example   { features: Features = 1 }
  Features  { feature: map<string, Feature> = 1 }
  Feature   { bytes_list = 1 | float_list = 2 | int64_list = 3 }
  BytesList { value: repeated bytes = 1 }
  FloatList { value: repeated float = 1 (packed or unpacked) }
  Int64List { value: repeated varint = 1 (packed or unpacked) }
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Union

FeatureValue = Union[List[bytes], List[float], List[int]]

_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    """Software CRC32-C (Castagnoli), table-driven."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def read_records(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Yield the raw record payloads of one tfrecord file, framed and
    CRC-checked by the native scanner (data/native.index_records).
    Raises IOError on corrupt framing or CRC."""
    from pivp_tpu_torch.data import native

    index = native.index_records(path, verify_crc)
    with open(path, "rb") as f:
        for offset, length in index:
            f.seek(offset)
            yield f.read(length)


def read_records_plain(path: str, verify_crc: bool = True
                       ) -> Iterator[bytes]:
    """The plain Python version of `read_records`: the same payloads and
    the same IOError on corruption, framed and CRC-checked in Python."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise IOError(f"truncated record header in {path}")
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:12])
            if verify_crc and _masked_crc(header[:8]) != len_crc:
                raise IOError(f"corrupt length CRC in {path}")
            data = f.read(length)
            if len(data) < length:
                raise IOError(f"truncated record in {path}")
            crc = f.read(4)
            if len(crc) < 4:
                raise IOError(f"truncated record in {path}")
            (data_crc,) = struct.unpack("<I", crc)
            if verify_crc and _masked_crc(data) != data_crc:
                raise IOError(f"corrupt data CRC in {path}")
            yield data


# ---------------------------------------------------------------------------
# Minimal protobuf wire parsing
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _read_fields(buf: bytes) -> Iterator:
    """Yield (field_number, wire_type, value) triples."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_float_list(buf: bytes) -> List[float]:
    out: List[float] = []
    for field, wire, val in _read_fields(buf):
        if field != 1:
            continue
        if wire == 2:  # packed
            out.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif wire == 5:
            out.append(struct.unpack("<f", val)[0])
    return out


def _parse_int64_list(buf: bytes) -> List[int]:
    out: List[int] = []
    for field, wire, val in _read_fields(buf):
        if field != 1:
            continue
        if wire == 2:  # packed varints
            pos = 0
            while pos < len(val):
                v, pos = _read_varint(val, pos)
                out.append(v)
        elif wire == 0:
            out.append(val)
    return out


def _parse_bytes_list(buf: bytes) -> List[bytes]:
    return [val for field, wire, val in _read_fields(buf)
            if field == 1 and wire == 2]


def _parse_feature(buf: bytes) -> FeatureValue:
    for field, wire, val in _read_fields(buf):
        if field == 1:
            return _parse_bytes_list(val)
        if field == 2:
            return _parse_float_list(val)
        if field == 3:
            return _parse_int64_list(val)
    return []


def parse_example(record: bytes) -> Dict[str, FeatureValue]:
    """Parse a serialized tf.train.Example into {key: list-of-values}."""
    features: Dict[str, FeatureValue] = {}
    for field, wire, val in _read_fields(record):
        if field != 1:  # Example.features
            continue
        for f2, w2, entry in _read_fields(val):
            if f2 != 1:  # Features.feature map entry
                continue
            key = None
            feature = []
            for f3, w3, v3 in _read_fields(entry):
                if f3 == 1:
                    key = v3.decode("utf-8")
                elif f3 == 2:
                    feature = _parse_feature(v3)
            if key is not None:
                features[key] = feature
    return features


def iter_examples(path: str) -> Iterator[Dict[str, FeatureValue]]:
    for record in read_records(path):
        yield parse_example(record)


# ---------------------------------------------------------------------------
# Writer (fixtures / round-trip tests / re-exporting datasets)
# ---------------------------------------------------------------------------

def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """Encode {key: list of bytes | float | int} as tf.train.Example."""
    entries = b""
    for key, values in features.items():
        if not values:
            continue
        if isinstance(values[0], bytes):
            lst = b"".join(_len_delimited(1, v) for v in values)
            feature = _len_delimited(1, lst)
        elif isinstance(values[0], float):
            packed = struct.pack(f"<{len(values)}f", *values)
            feature = _len_delimited(2, _len_delimited(1, packed))
        else:
            packed = b"".join(_varint(int(v)) for v in values)
            feature = _len_delimited(3, _len_delimited(1, packed))
        entry = _len_delimited(1, key.encode("utf-8")) + \
            _len_delimited(2, feature)
        entries += _len_delimited(1, entry)
    return _len_delimited(1, entries)


def write_records(path: str, records) -> None:
    with open(path, "wb") as f:
        for data in records:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))
