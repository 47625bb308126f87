from . import frame
