"""Native host code of the port: the CABAC slice coder and arithmetic
engine, the level-pack decoder and the EPB escaper, C++ sources built
with ``g++`` at first use (see :mod:`.lib`)."""
