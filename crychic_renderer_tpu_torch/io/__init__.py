from . import dds
