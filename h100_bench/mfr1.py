"""The MFR1 raw frame of the serving daemon's /v1/predict, frozen for the load generator.

Request (little-endian): b"MFR1", dtype codes of img, v2d and the response
(0 float32, 1 float16), a reserved byte, S, H, W as uint32, the seed as
int64, a reserved uint32, then img (S,1,H,W) and v2d (S,3,H,W) raw.
Response: b"MFR1", the velocity's dtype code, 3 reserved bytes, S, H, W as
uint32, then the velocity (S,3,H,W) raw.
"""
from __future__ import annotations

import struct

import numpy as np

MAGIC = b"MFR1"
_DTYPES = {0: np.float32, 1: np.float16}


def request_body(img: np.ndarray, v2d: np.ndarray) -> bytes:
    """The raw buffers of a float32 request, after its header."""
    return (np.ascontiguousarray(img, np.float32).tobytes()
            + np.ascontiguousarray(v2d, np.float32).tobytes())


def request_header(shape: tuple, seed: int) -> bytes:
    """The 32-byte header of a float32 request of (S, H, W) ``shape``."""
    s, h, w = shape
    return struct.pack("<4sBBBBIIIqI", MAGIC, 0, 0, 0, 0, s, h, w, int(seed), 0)


def encode_request(img: np.ndarray, v2d: np.ndarray, seed: int) -> bytes:
    return request_header((img.shape[0], img.shape[2], img.shape[3]), seed) + request_body(img, v2d)


def decode_response(body: bytes) -> np.ndarray:
    if len(body) < 20 or body[:4] != MAGIC:
        raise ValueError("not an MFR1 response")
    _, code, _a, _b, _c, s, h, w = struct.unpack("<4sBBBBIII", body[:20])
    dt = np.dtype(_DTYPES[code])
    if len(body) != 20 + s * 3 * h * w * dt.itemsize:
        raise ValueError("MFR1 response size mismatch")
    return np.frombuffer(body, dt, count=s * 3 * h * w, offset=20).reshape(s, 3, h, w)
