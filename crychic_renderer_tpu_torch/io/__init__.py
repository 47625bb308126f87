from . import dds
from . import mesh_txt
