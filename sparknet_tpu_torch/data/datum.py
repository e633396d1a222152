"""Datum record codec — the value type of Caffe LMDB/LevelDB databases.

``Datum`` (reference caffe/src/caffe/proto/caffe.proto:30-44) is what
``convert_imageset``/``convert_cifar_data`` write and what the DataLayer's
reader decodes (data_layer.cpp:14-60 via DataTransformer). Fields:
1 channels, 2 height, 3 width, 4 data (bytes, CHW uint8), 5 label,
6 float_data (repeated float, used instead of `data` by some exporters),
7 encoded (bool: `data` holds a compressed image, JPEG/PNG).

The port's copy of sparknet_tpu/data/datum.py. The generic schema-driven
codec in ``proto/wire.py`` handles Datum too; this module adds a hand-rolled single-pass parser because datum
decode sits on the training hot path (one parse per image per epoch) and
the generic path's Message construction is ~10x the cost of the tag walk.
"""

import numpy as np

from ..proto.wire import encode as _wire_encode


class DatumError(ValueError):
    pass


def parse_datum(buf):
    """bytes -> (channels, height, width, data, float_data, label, encoded).

    data is a bytes view (CHW uint8) or None; float_data is a float32 array
    or None. Unknown fields are skipped (proto2 forward compatibility)."""
    channels = height = width = label = 0
    data = None
    floats = []
    encoded = False
    pos, end = 0, len(buf)
    while pos < end:
        tag = buf[pos]
        pos += 1
        if tag & 0x80:  # multi-byte tag: fields >15 don't exist in Datum,
            shift = 7   # but skip them correctly anyway
            while buf[pos - 1] & 0x80:
                tag |= (buf[pos] & 0x7F) << shift
                shift += 7
                pos += 1
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            v = 0
            shift = 0
            while True:
                b = buf[pos]
                pos += 1
                v |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            if field == 1:
                channels = v
            elif field == 2:
                height = v
            elif field == 3:
                width = v
            elif field == 5:
                label = v - (1 << 64) if v >= (1 << 63) else v
            elif field == 7:
                encoded = bool(v)
        elif wt == 2:  # length-delimited
            n = 0
            shift = 0
            while True:
                b = buf[pos]
                pos += 1
                n |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            chunk = buf[pos:pos + n]
            pos += n
            if field == 4:
                data = chunk
            elif field == 6:  # packed float_data
                floats.append(np.frombuffer(chunk, "<f4"))
        elif wt == 5:  # 32-bit: unpacked float_data
            if field == 6:
                floats.append(np.frombuffer(buf[pos:pos + 4], "<f4"))
            pos += 4
        elif wt == 1:
            pos += 8
        else:
            raise DatumError(f"unsupported wire type {wt} in Datum")
    float_data = np.concatenate(floats) if floats else None
    return channels, height, width, data, float_data, label, encoded


def datum_to_array(buf):
    """Serialized Datum -> (CHW array, label).

    Raw data -> uint8; float_data -> float32; encoded (JPEG/PNG) -> decoded
    to uint8 CHW in BGR channel order, matching the reference's OpenCV
    decode path (io.cpp DecodeDatumToCVMat + CVMatToDatum store BGR)."""
    c, h, w, data, float_data, label, encoded = parse_datum(buf)
    if encoded:
        import io as _io
        from PIL import Image
        img = Image.open(_io.BytesIO(bytes(data))).convert("RGB")
        rgb = np.asarray(img, np.uint8)           # HWC RGB
        arr = rgb[:, :, ::-1].transpose(2, 0, 1)  # CHW BGR
        return np.ascontiguousarray(arr), label
    if data is not None and len(data):
        arr = np.frombuffer(bytes(data), np.uint8)
        if c and h and w:
            arr = arr.reshape(c, h, w)
        return arr, label
    if float_data is not None:
        arr = float_data
        if c and h and w:
            arr = arr.reshape(c, h, w)
        return arr, label
    raise DatumError("Datum has neither data nor float_data")


def encoded_datum(image_bytes, label=0, dims=(0, 0, 0)):
    """Compressed (JPEG/PNG) image bytes -> Datum bytes with encoded=true
    (what convert_imageset --encoded writes; io.cpp ReadImageToDatum)."""
    out = bytearray()
    c, h, w = dims
    _tag_varint(out, 1, c)
    _tag_varint(out, 2, h)
    _tag_varint(out, 3, w)
    out += b"\x22" + _varint(len(image_bytes)) + image_bytes
    _tag_varint(out, 5, label)
    _tag_varint(out, 7, 1)
    return bytes(out)


def array_to_datum(arr, label=0):
    """CHW array -> Datum bytes (uint8 -> `data`, float -> `float_data`)."""
    out = bytearray()
    arr = np.asarray(arr)
    if arr.ndim != 3:
        raise DatumError(f"expected CHW array, got shape {arr.shape}")
    c, h, w = arr.shape
    _tag_varint(out, 1, c)
    _tag_varint(out, 2, h)
    _tag_varint(out, 3, w)
    if arr.dtype == np.uint8:
        raw = np.ascontiguousarray(arr).tobytes()
        out += b"\x22" + _varint(len(raw)) + raw       # field 4, wt 2
        _tag_varint(out, 5, label)
    else:
        packed = np.ascontiguousarray(arr, "<f4").tobytes()
        _tag_varint(out, 5, label)
        out += b"\x32" + _varint(len(packed)) + packed  # field 6 packed
    return bytes(out)


def datum_message(buf):
    """Full schema-driven decode to a Message (slow path, for tools)."""
    from ..proto import wire
    return wire.decode(buf, "Datum")


def message_to_bytes(msg):
    return _wire_encode(msg)


def _varint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag_varint(out, field, value):
    if value:
        out += bytes([field << 3]) + _varint(value)
