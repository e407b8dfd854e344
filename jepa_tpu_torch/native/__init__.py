"""The native FFmpeg video decoder (``videodec.cpp``, bound with ctypes)."""
