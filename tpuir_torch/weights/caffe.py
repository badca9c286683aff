"""Direct .caffemodel reader (protobuf wire format, no protoc).

A copy of ``tpuir/weights/caffe.py`` (NumPy only), held bit-equal to it by
``tests/test_torch_plain_conv.py``. A .caffemodel is a serialized
NetParameter whose layers (new format, field 100) or V1 layers (old format,
field 2) carry BlobProto weights; only the fields needed for weight
extraction are parsed, everything else is skipped by wire type.

Output follows the original converter's convention (caffemodel2pytorch):
``{layer_name}.weight`` and ``{layer_name}.bias`` NumPy arrays with Caffe's
blob dims. Conv blobs are OIHW and Deconvolution blobs (in, out, kh, kw),
which is ``nn.ConvTranspose2d``'s own layout, so
``tpuir_torch.models.rednet.REDNet`` loads them as they are.

``write_caffemodel`` is the port's own addition: it encodes a state dict of
such blobs as a new-format NetParameter, for seeded checkpoints in the
released format (``chip_smoke.py`` and the tests).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_WT_VARINT = 0
_WT_I64 = 1
_WT_LEN = 2
_WT_I32 = 5


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _skip(buf: memoryview, pos: int, wt: int) -> int:
    if wt == _WT_VARINT:
        _, pos = _read_varint(buf, pos)
        return pos
    if wt == _WT_I64:
        return pos + 8
    if wt == _WT_LEN:
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wt == _WT_I32:
        return pos + 4
    raise ValueError(f"unsupported wire type {wt}")


def _fields(buf: memoryview):
    """Yield (field_number, wire_type, value) where value is bytes for LEN,
    int for VARINT, raw 4/8 bytes for fixed."""
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        fn, wt = tag >> 3, tag & 7
        if wt == _WT_VARINT:
            v, pos = _read_varint(buf, pos)
            yield fn, wt, v
        elif wt == _WT_LEN:
            n, pos = _read_varint(buf, pos)
            yield fn, wt, buf[pos : pos + n]
            pos += n
        elif wt == _WT_I32:
            yield fn, wt, buf[pos : pos + 4]
            pos += 4
        elif wt == _WT_I64:
            yield fn, wt, buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")


def _parse_blob(buf: memoryview) -> np.ndarray:
    shape: List[int] = []
    old_dims = {}
    data_chunks: List[np.ndarray] = []
    double_chunks: List[np.ndarray] = []
    for fn, wt, v in _fields(buf):
        if fn == 7 and wt == _WT_LEN:  # BlobShape
            for sfn, swt, sv in _fields(v):
                if sfn == 1:
                    if swt == _WT_LEN:  # packed int64 varints
                        p = 0
                        while p < len(sv):
                            d, p = _read_varint(sv, p)
                            shape.append(d)
                    else:
                        shape.append(sv)
        elif fn == 5:  # float data
            if wt == _WT_LEN:  # packed
                data_chunks.append(np.frombuffer(bytes(v), dtype="<f4"))
            else:  # unpacked single float
                data_chunks.append(np.frombuffer(bytes(v), dtype="<f4"))
        elif fn == 8:  # double data
            double_chunks.append(np.frombuffer(bytes(v), dtype="<f8"))
        elif fn in (1, 2, 3, 4) and wt == _WT_VARINT:  # old num/channels/h/w
            old_dims[fn] = v
    if double_chunks:
        data = np.concatenate(double_chunks).astype(np.float32)
    else:
        data = (
            np.concatenate(data_chunks) if data_chunks else np.empty(0, np.float32)
        )
    if not shape and old_dims:
        shape = [old_dims.get(i, 1) for i in (1, 2, 3, 4)]
        # Trim leading 1s the way caffe's legacy 4-D blobs imply vectors
        while len(shape) > 1 and shape[0] == 1:
            shape = shape[1:]
    if shape and int(np.prod(shape)) == data.size:
        return data.reshape(shape)
    return data


def _parse_layer(buf: memoryview, v1: bool):
    name = None
    blobs: List[np.ndarray] = []
    name_field = 4 if v1 else 1
    blob_field = 6 if v1 else 7
    for fn, wt, v in _fields(buf):
        if fn == name_field and wt == _WT_LEN:
            name = bytes(v).decode("utf-8", "replace")
        elif fn == blob_field and wt == _WT_LEN:
            blobs.append(_parse_blob(v))
    return name, blobs


def read_caffemodel(path: str) -> Dict[str, List[np.ndarray]]:
    """Parse a .caffemodel into {layer_name: [blob, ...]} (layers with blobs)."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    layers: Dict[str, List[np.ndarray]] = {}
    for fn, wt, v in _fields(buf):
        if wt != _WT_LEN:
            continue
        if fn == 100:  # new LayerParameter
            name, blobs = _parse_layer(v, v1=False)
        elif fn == 2:  # V1LayerParameter
            name, blobs = _parse_layer(v, v1=True)
        else:
            continue
        if name and blobs:
            layers[name] = blobs
    return layers


def caffemodel_to_state_dict(path: str) -> Dict[str, np.ndarray]:
    """{layer}.weight / {layer}.bias arrays, as the reference CLI emits
    (caffemodel2pytorch.py:366-439)."""
    sd: Dict[str, np.ndarray] = {}
    for name, blobs in read_caffemodel(path).items():
        if len(blobs) >= 1:
            sd[f"{name}.weight"] = blobs[0]
        if len(blobs) >= 2:
            sd[f"{name}.bias"] = blobs[1]
    return sd


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_field(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | _WT_LEN) + _varint(len(payload)) + payload


def _blob(arr: np.ndarray) -> bytes:
    dims = b"".join(_varint(int(d)) for d in arr.shape)
    shape = _len_field(1, dims)  # BlobShape.dim, packed
    return _len_field(7, shape) + _len_field(5, np.ascontiguousarray(arr, "<f4").tobytes())


def write_caffemodel(path: str, state_dict: Dict[str, np.ndarray],
                     name: str = "net") -> None:
    """Write ``{layer}.weight`` / ``{layer}.bias`` arrays as a new-format
    NetParameter: one LayerParameter a layer, in the dict's order, its type
    "Deconvolution" where the name starts with "deconv", else
    "Convolution". ``read_caffemodel`` reads it back as it was."""
    layers: Dict[str, List[np.ndarray]] = {}
    for key, arr in state_dict.items():
        layer, kind = key.rsplit(".", 1)
        layers.setdefault(layer, [None, None])[kind == "bias"] = np.asarray(arr, np.float32)
    out = bytearray(_len_field(1, name.encode()))
    for layer, blobs in layers.items():
        kind = b"Deconvolution" if layer.startswith("deconv") else b"Convolution"
        body = _len_field(1, layer.encode()) + _len_field(2, kind)
        body += b"".join(_len_field(7, _blob(b)) for b in blobs if b is not None)
        out += _len_field(100, body)
    with open(path, "wb") as f:
        f.write(bytes(out))
