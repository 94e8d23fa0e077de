"""Standalone data-preparation utilities (heat_tpu ``utils/data/_utils.py``,
after the original Heat's ``heat/utils/data/_utils.py:13-279``, which Heat
itself marks as untested, unsupported helpers).

Everything here is TensorFlow-free:

* the tfrecord index walker reads the ``(u64 length, u32 crc, proto bytes,
  u32 crc)`` frames with ``struct``;
* :func:`parse_tf_example` decodes ``tf.train.Example`` protos with a
  minimal protobuf **wire-format** parser (the Example schema is three
  tiny fixed messages — no protobuf runtime or generated classes needed);
* the ImageNet merger decodes JPEGs with Pillow instead of
  ``tf.image.decode_jpeg`` and writes Heat's exact HDF5 layout.
"""

import base64
import os
import struct

__all__ = ["tfrecord_index", "dali_tfrecord2idx", "parse_tf_example",
           "merge_files_imagenet_tfrecord"]


def tfrecord_index(path):
    """Return ``[(offset, nbytes), ...]`` for every record frame in a
    TFRecord file (the DALI index format, one frame per line)."""
    entries = []
    with open(path, "rb") as f:
        while True:
            current = f.tell()
            byte_len = f.read(8)
            if len(byte_len) == 0:
                break
            if len(byte_len) < 8:
                raise ValueError(f"{path}: truncated TFRecord length header")
            (proto_len,) = struct.unpack("<q", byte_len)
            if proto_len < 0:
                raise ValueError(f"{path}: negative TFRecord length (not a TFRecord file)")
            if len(f.read(4)) < 4:
                raise ValueError(f"{path}: truncated TFRecord length crc")
            body = f.read(proto_len)
            if len(body) < proto_len:
                raise ValueError(f"{path}: truncated TFRecord body")
            if len(f.read(4)) < 4:
                raise ValueError(f"{path}: truncated TFRecord body crc")
            entries.append((current, f.tell() - current))
    return entries


def dali_tfrecord2idx(train_dir, train_idx_dir, val_dir, val_idx_dir):
    """Write DALI-style ``offset nbytes`` index files for every TFRecord in
    ``train_dir`` / ``val_dir`` (Heat ``_utils.py:13-44``)."""
    for src_dir, out_dir in ((train_dir, train_idx_dir), (val_dir, val_idx_dir)):
        os.makedirs(out_dir, exist_ok=True)
        for name in sorted(os.listdir(src_dir)):
            src = os.path.join(src_dir, name)
            if not os.path.isfile(src):
                continue
            try:
                entries = tfrecord_index(src)
            except ValueError:
                print(f"Not a valid TFRecord file: {src}")
                continue
            with open(os.path.join(out_dir, name), "w") as idx:
                for offset, nbytes in entries:
                    idx.write(f"{offset} {nbytes}\n")


# --------------------------------------------------------------------------- #
# tf.train.Example wire-format parsing (no TensorFlow, no protobuf runtime)   #
# --------------------------------------------------------------------------- #
#
# Example      { Features features = 1; }
# Features     { map<string, Feature> feature = 1; }   (map entry: key=1, value=2)
# Feature      { oneof { BytesList bytes_list = 1; FloatList float_list = 2;
#                        Int64List int64_list = 3; } }
# BytesList    { repeated bytes value = 1; }
# FloatList    { repeated float value = 1 [packed]; }
# Int64List    { repeated int64 value = 1 [packed]; }


def _varint(buf, pos):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf):
    """Yield ``(field_number, wire_type, value)`` over one message body.
    Wire type 0 -> varint int, 1 -> 8 raw bytes, 2 -> bytes, 5 -> 4 raw
    bytes; groups (3/4) don't occur in the Example schema."""
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            ln, pos = _varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        elif wire == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:  # pragma: no cover - not produced by the Example schema
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _parse_list(body, kind):
    """Decode a BytesList/FloatList/Int64List message body into a list."""
    out = []
    for field, wire, val in _fields(body):
        if field != 1:
            continue
        if kind == "bytes":
            out.append(val)
        elif kind == "float":
            if wire == 2:  # packed
                out.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                out.append(struct.unpack("<f", val)[0])
        else:  # int64
            if wire == 2:  # packed varints
                pos = 0
                while pos < len(val):
                    v, pos = _varint(val, pos)
                    out.append(v - (1 << 64) if v >= 1 << 63 else v)
            else:
                out.append(val - (1 << 64) if val >= 1 << 63 else val)
    return out


def parse_tf_example(raw):
    """Parse a serialized ``tf.train.Example`` into
    ``{name: list}`` (bytes, float or int values per feature) — the
    TensorFlow-free stand-in for ``tf.train.Example.FromString``
    (Heat ``_utils.py:165``)."""
    features = {}
    for field, _wire, val in _fields(raw):
        if field != 1:  # Example.features
            continue
        for f2, _w2, entry in _fields(val):
            if f2 != 1:  # Features.feature map entry
                continue
            key, body = None, b""
            for f3, _w3, v3 in _fields(entry):
                if f3 == 1:
                    key = v3.decode("utf-8")
                elif f3 == 2:
                    body = v3
            if key is None:
                continue
            values = []
            for f4, _w4, v4 in _fields(body):  # the Feature oneof
                if f4 == 1:
                    values = _parse_list(v4, "bytes")
                elif f4 == 2:
                    values = _parse_list(v4, "float")
                elif f4 == 3:
                    values = _parse_list(v4, "int64")
            features[key] = values
    return features


def _feat(parsed, name, default=None):
    vals = parsed.get(name) or []
    if not vals:
        if default is None:
            raise IndexError(name)
        return default
    return vals[0]


def merge_files_imagenet_tfrecord(folder_name, output_folder=None):
    """Merge preprocessed ImageNet TFRecords into HDF5 files (Heat
    ``_utils.py:46-279``), TensorFlow-free: record framing via
    :func:`tfrecord_index`, proto decoding via :func:`parse_tf_example`,
    JPEG decoding via Pillow. Output layout matches Heat's:
    ``imagenet_merged.h5`` / ``imagenet_merged_validation.h5`` with
    ``images`` (base64 ascii of the decoded RGB bytes), ``metadata``
    (9 float columns) and ``file_info`` (4 string columns), plus the
    ``column_names`` attributes.

    (Heat's own file listing crashes — ``list.sort()`` returns
    ``None`` into ``len()`` — consistent with its "untested, unsupported"
    banner; the intent, a sorted train/val split by filename prefix, is
    implemented here.)
    """
    import io

    import h5py
    import numpy as np

    try:
        from PIL import Image
    except ImportError as exc:  # pragma: no cover - env without Pillow
        raise ImportError(
            "merge_files_imagenet_tfrecord decodes JPEGs with Pillow; "
            "install it (pip install pillow) — TensorFlow is NOT needed"
        ) from exc

    output_folder = output_folder or ""
    train_names = sorted(
        os.path.join(folder_name, f) for f in os.listdir(folder_name)
        if f.startswith("train"))
    val_names = sorted(
        os.path.join(folder_name, f) for f in os.listdir(folder_name)
        if f.startswith("val"))

    dt = h5py.string_dtype(encoding="ascii")

    def _single_file_load(src):
        imgs = []
        img_meta = [[] for _ in range(9)]
        file_arr = [[] for _ in range(4)]
        with open(src, "rb") as fh:
            for offset, nbytes in tfrecord_index(src):
                fh.seek(offset + 12)  # skip length + length-crc
                parsed = parse_tf_example(fh.read(nbytes - 16))
                img_bytes = _feat(parsed, "image/encoded")
                img = np.asarray(
                    Image.open(io.BytesIO(img_bytes)).convert("RGB"),
                    dtype=np.uint8)
                imgs.append(base64.binascii.b2a_base64(
                    img.tobytes()).decode("ascii"))
                img_meta[0].append(float(_feat(parsed, "image/height")))
                img_meta[1].append(float(_feat(parsed, "image/width")))
                img_meta[2].append(float(_feat(parsed, "image/channels")))
                img_meta[3].append(_feat(parsed, "image/class/label") - 1)
                try:
                    bbxmin = _feat(parsed, "image/object/bbox/xmin")
                    bbxmax = _feat(parsed, "image/object/bbox/xmax")
                    bbymin = _feat(parsed, "image/object/bbox/ymin")
                    bbymax = _feat(parsed, "image/object/bbox/ymax")
                    bblabel = _feat(parsed, "image/object/bbox/label") - 1
                except IndexError:
                    bbxmin, bbxmax = 0.0, img_meta[1][-1]
                    bbymin, bbymax = 0.0, img_meta[0][-1]
                    bblabel = -2
                img_meta[4].append(float(bbxmin))
                img_meta[5].append(float(bbxmax))
                img_meta[6].append(float(bbymin))
                img_meta[7].append(float(bbymax))
                img_meta[8].append(bblabel)
                file_arr[0].append(_feat(parsed, "image/format", b"JPEG"))
                file_arr[1].append(_feat(parsed, "image/filename", b""))
                file_arr[2].append(_feat(parsed, "image/class/synset", b""))
                file_arr[3].append(_feat(parsed, "image/class/text", b""))
        return (imgs, np.array(img_meta, dtype=np.float64).T,
                np.array(file_arr, dtype="S10").T)

    def _write(file, imgs, img_meta, file_arr, past):
        file["images"].resize((past + len(imgs),))
        file["images"][past:past + len(imgs)] = imgs
        file["metadata"].resize((past + img_meta.shape[0], 9))
        file["metadata"][past:past + img_meta.shape[0]] = img_meta
        file["file_info"].resize((past + file_arr.shape[0], 4))
        file["file_info"][past:past + file_arr.shape[0]] = file_arr

    def _merge(names, out_path):
        with h5py.File(out_path, "w") as f:
            f.create_dataset("images", (0,), chunks=True, maxshape=(None,),
                             dtype=dt)
            f.create_dataset("metadata", (0, 9), chunks=True,
                             maxshape=(None, 9))
            f.create_dataset("file_info", (0, 4), chunks=True,
                             maxshape=(None, 4), dtype="S10")
            past = 0
            for src in names:  # one file at a time: O(file) host memory
                imgs, img_meta, file_arr = _single_file_load(src)
                if imgs:
                    _write(f, imgs, img_meta, file_arr, past)
                    past += len(imgs)
            f["metadata"].attrs["column_names"] = [
                "image/height", "image/width", "image/channels",
                "image/class/label", "image/object/bbox/xmin",
                "image/object/bbox/xmax", "image/object/bbox/ymin",
                "image/object/bbox/ymax", "image/object/bbox/label"]
            f["file_info"].attrs["column_names"] = [
                "image/format", "image/filename", "image/class/synset",
                "image/class/text"]

    _merge(train_names, os.path.join(output_folder, "imagenet_merged.h5"))
    _merge(val_names,
           os.path.join(output_folder, "imagenet_merged_validation.h5"))
