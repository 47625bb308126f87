from . import geometry
from . import camera
