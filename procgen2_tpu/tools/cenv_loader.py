"""Minimal ctypes loader for reference CEnv shared libraries.

Interop shim for the parity/difference harness: loads any .so conforming
to the CEnv C ABI (`/root/reference/cenv/cenv.h:29-133` — 4 exported
data globals + 6 exported functions with tagged-union payloads) and
drives it step by step. Written fresh against the ABI contract; only the
struct layouts are (necessarily) dictated by the header.

Not part of the JAX execution path — this exists so tests can compare
the JAX engines against the original C++ engines when a compiled
reference .so is available (the difference_viewer pattern, SURVEY.md §4).
"""
from __future__ import annotations

import ctypes as ct
from typing import Optional

import numpy as np

# cenv_value_type (cenv.h:29-39)
T_INT, T_FLOAT, T_DOUBLE, T_BYTE, T_BOX, T_MULTI_DISCRETE = range(6)


class _Value(ct.Union):
    _fields_ = [("i", ct.c_int32), ("f", ct.c_float),
                ("d", ct.c_double), ("b", ct.c_uint8)]


class _Buffer(ct.Union):
    _fields_ = [("i", ct.POINTER(ct.c_int32)), ("f", ct.POINTER(ct.c_float)),
                ("d", ct.POINTER(ct.c_double)), ("b", ct.POINTER(ct.c_uint8))]


class _KeyValue(ct.Structure):
    _fields_ = [("key", ct.c_char_p), ("value_type", ct.c_int32),
                ("value_buffer_size", ct.c_int32), ("value_buffer", _Buffer)]


class _Option(ct.Structure):
    _fields_ = [("name", ct.c_char_p), ("value_type", ct.c_int32),
                ("value", _Value)]


class _MakeData(ct.Structure):
    _fields_ = [("observation_spaces_size", ct.c_int32),
                ("observation_spaces", ct.POINTER(_KeyValue)),
                ("action_spaces_size", ct.c_int32),
                ("action_spaces", ct.POINTER(_KeyValue))]


class _ResetData(ct.Structure):
    _fields_ = [("observations_size", ct.c_int32),
                ("observations", ct.POINTER(_KeyValue)),
                ("infos_size", ct.c_int32),
                ("infos", ct.POINTER(_KeyValue))]


class _StepData(ct.Structure):
    _fields_ = [("observations_size", ct.c_int32),
                ("observations", ct.POINTER(_KeyValue)),
                ("reward", _Value),
                ("terminated", ct.c_bool), ("truncated", ct.c_bool),
                ("infos_size", ct.c_int32),
                ("infos", ct.POINTER(_KeyValue))]


class _RenderData(ct.Structure):
    _fields_ = [("value_type", ct.c_int32),
                ("value_buffer_width", ct.c_int32),
                ("value_buffer_height", ct.c_int32),
                ("value_buffer_channels", ct.c_int32),
                ("value_buffer", _Buffer)]


def _options_array(options: dict):
    opts = (_Option * len(options))()
    for i, (name, value) in enumerate(options.items()):
        opts[i].name = name.encode()
        if isinstance(value, int):
            opts[i].value_type = T_INT
            opts[i].value.i = value
        elif isinstance(value, float):
            opts[i].value_type = T_DOUBLE
            opts[i].value.d = value
        else:
            raise TypeError(f"unsupported option type for {name!r}: {type(value)}")
    return opts


def _read_kv(kv: _KeyValue) -> np.ndarray:
    n = kv.value_buffer_size
    if kv.value_type in (T_BYTE,):
        return np.ctypeslib.as_array(kv.value_buffer.b, (n,)).copy()
    if kv.value_type in (T_INT, T_MULTI_DISCRETE):
        return np.ctypeslib.as_array(kv.value_buffer.i, (n,)).copy()
    if kv.value_type in (T_FLOAT, T_BOX):
        return np.ctypeslib.as_array(kv.value_buffer.f, (n,)).copy()
    return np.ctypeslib.as_array(kv.value_buffer.d, (n,)).copy()


class ReferenceEnv:
    """One episode-at-a-time handle on a reference game .so."""

    def __init__(self, lib_path: str, seed: Optional[int] = None,
                 width: int = 64, height: int = 64):
        self.lib = ct.CDLL(lib_path)
        for name, restype in (
            ("cenv_get_env_version", ct.c_int32),
            ("cenv_make", ct.c_int32), ("cenv_reset", ct.c_int32),
            ("cenv_step", ct.c_int32), ("cenv_render", ct.c_int32),
        ):
            getattr(self.lib, name).restype = restype
        self.make_data = _MakeData.in_dll(self.lib, "make_data")
        self.reset_data = _ResetData.in_dll(self.lib, "reset_data")
        self.step_data = _StepData.in_dll(self.lib, "step_data")
        self.render_data = _RenderData.in_dll(self.lib, "render_data")

        options = {"width": width, "height": height}
        if seed is not None:
            options["seed"] = seed
        opts = _options_array(options)
        rc = self.lib.cenv_make(b"rgb_array", opts, len(opts))
        if rc != 0:
            raise RuntimeError(f"cenv_make failed: {rc}")

    @property
    def version(self) -> int:
        return int(self.lib.cenv_get_env_version())

    def reset(self, seed: Optional[int] = None) -> np.ndarray:
        opts = _options_array({} if seed is None else {"seed": seed})
        rc = self.lib.cenv_reset(opts, len(opts))
        if rc != 0:
            raise RuntimeError(f"cenv_reset failed: {rc}")
        obs = _read_kv(self.reset_data.observations[0])
        return obs.reshape(64, 64, 3)

    def step(self, action: int):
        buf = (ct.c_int32 * 1)(int(action))
        kv = (_KeyValue * 1)()
        kv[0].key = b"action"
        kv[0].value_type = T_INT
        kv[0].value_buffer_size = 1
        kv[0].value_buffer.i = buf
        rc = self.lib.cenv_step(kv, 1)
        if rc != 0:
            raise RuntimeError(f"cenv_step failed: {rc}")
        obs = _read_kv(self.step_data.observations[0]).reshape(64, 64, 3)
        return (obs, float(self.step_data.reward.f),
                bool(self.step_data.terminated), bool(self.step_data.truncated))

    def close(self):
        self.lib.cenv_close()
