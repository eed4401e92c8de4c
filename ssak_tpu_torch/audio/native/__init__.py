"""The port's host C++ audio code, one library per source, each built by
g++ at first use (ops/_build.host_library) and loaded with ctypes:

  durations.cpp  parallel WAV / FLAC header scan (`scan_durations`)
  flacdec.cpp    FLAC decoder of the port's own (audio/flac.py)
  mp3dec.cpp     MP3 through the system libmpg123, dlopen'd (audio/mp3.py)
  avdec.cpp      other ffmpeg formats, linked to libavformat / libavcodec /
                 libavutil (audio/flac.read_any)

One library per source: a host without ffmpeg's libraries fails to build
avdec.cpp only, and one without libmpg123 still scans durations and
decodes FLAC. A failed build raises (no fallback).
"""

import ctypes
import os

HERE = os.path.dirname(os.path.abspath(__file__))

_C = ctypes
_FP = _C.POINTER(_C.c_float)
_IP = _C.POINTER(_C.c_int)
# name -> (link flags, {function: (restype, argtypes)})
SOURCES = {
    "durations": (("-pthread",), {
        "ssak_scan_durations": (None, [_C.POINTER(_C.c_char_p), _C.c_int32, _C.c_int32, _C.POINTER(_C.c_double)]),
    }),
    "flacdec": ((), {
        "ssak_flac_info": (_C.c_int, [_C.c_char_p, _C.c_size_t, _IP, _IP, _IP, _C.POINTER(_C.c_uint64)]),
        "ssak_flac_decode": (_C.c_long, [_C.c_char_p, _C.c_size_t, _C.POINTER(_FP), _IP, _IP]),
        "ssak_flac_free": (None, [_FP]),
    }),
    "mp3dec": (("-ldl",), {
        "ssak_mp3_available": (_C.c_int, []),
        "ssak_mp3_decode": (_C.c_long, [_C.c_char_p, _C.c_size_t, _FP, _C.c_size_t, _IP, _IP]),
    }),
    "avdec": (("-lavformat", "-lavcodec", "-lavutil"), {
        "ssak_av_decode": (_C.c_long, [_C.c_char_p, _FP, _C.c_size_t, _IP, _IP]),
        "ssak_av_duration": (_C.c_double, [_C.c_char_p]),
    }),
}
_typed = set()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of audio/native/<name>.cpp, built on first use;
    raises RuntimeError when the build fails."""
    from ssak_tpu_torch.ops._build import host_library

    libs, functions = SOURCES[name]
    lib = host_library(os.path.join(HERE, name + ".cpp"), libs=libs)
    if name not in _typed:
        for fn, (restype, argtypes) in functions.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _typed.add(name)
    return lib


def scan_durations(paths, n_threads: int = 8):
    """Parallel header-only duration scan (WAV/FLAC) in C++: seconds per
    path, None for files the scanner cannot parse (mp3, pipes, broken
    headers), which the caller reads one at a time."""
    n = len(paths)
    if n == 0:
        return []
    lib = library("durations")
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    out = (ctypes.c_double * n)()
    lib.ssak_scan_durations(arr, n, n_threads, out)
    return [d if d >= 0 else None for d in out]
