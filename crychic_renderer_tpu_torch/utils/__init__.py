from . import mathutil
from . import msvcrand
