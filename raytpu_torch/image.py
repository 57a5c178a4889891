"""Image output: the golden tone-map contract and binary P6 PPM I/O.

numpy only, byte for byte raytpu.image's contract.  savePPM
(main.cpp:43-91) writes `P6\\nW H\\n255\\n` then, per channel,
`(unsigned char)(min(1.f, c) * 255 / maxColourVal)`: the clamp to 1.0 comes
BEFORE the divide by the global max, there is no gamma, NaN clamps to 1
(std::min(1.f, NaN) == 1.f) and the cast truncates toward zero.
maxColourVal is the global channel max with an all-black -> 1.0 guard
(algebra.h:68-91).
"""

from __future__ import annotations

import numpy as np


def max_colour_value(img) -> np.float32:
    """Global channel max with the 0 -> 1 guard (algebra.h:68-91).  NaN
    channels never update the max (C's `x > max` is false for NaN)."""
    arr = np.asarray(img, np.float32)
    finite = arr[~np.isnan(arr)]
    m = np.float32(finite.max()) if finite.size else np.float32(0.0)
    m = max(m, np.float32(0.0))
    return np.float32(1.0) if m == 0.0 else np.float32(m)


def tone_map(img, max_val=None) -> np.ndarray:
    """Float (H, W, 3) linear colour -> uint8 via the reference transform."""
    arr = np.asarray(img, np.float32)
    if max_val is None:
        max_val = max_colour_value(arr)
    clamped = np.where(np.isnan(arr), np.float32(1.0),
                       np.minimum(arr, np.float32(1.0)))
    scaled = clamped * np.float32(255.0) / np.float32(max_val)
    # C cast float -> unsigned char: truncate toward zero, keep the low byte.
    return (scaled.astype(np.int64) & 0xFF).astype(np.uint8)


def write_ppm(img, path, max_val=None) -> None:
    """Write a binary P6 PPM exactly as savePPM (main.cpp:43-91) does."""
    arr = np.asarray(img)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) image, got {arr.shape}")
    data = tone_map(arr, max_val) if arr.dtype != np.uint8 else arr
    h, w = data.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode("ascii"))
        f.write(data.tobytes())


def read_ppm(path) -> np.ndarray:
    """Read a binary P6 PPM -> uint8 (H, W, 3)."""
    with open(path, "rb") as f:
        data = f.read()
    # Header: magic, width, height, maxval — whitespace separated, with
    # optional '#' comments.
    fields = []
    pos = 0
    while len(fields) < 4:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos : pos + 1] != b"\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        fields.append(data[start:pos])
    pos += 1  # single whitespace after maxval
    if fields[0] != b"P6":
        raise ValueError(f"not a binary PPM: {fields[0]!r}")
    w, h, maxval = int(fields[1]), int(fields[2]), int(fields[3])
    if maxval != 255:
        raise ValueError(f"unsupported maxval {maxval}")
    img = np.frombuffer(data, np.uint8, count=w * h * 3, offset=pos)
    return img.reshape(h, w, 3).copy()
