"""The codec of the port: real rANS bitstreams of an mshyper model.

The device computes the latents, coding grids and CDF tables; the host does
the sequential entropy coding in a small C++ library (rans.cc) bound with
ctypes. api.py holds the model-level compress/decompress.
"""
