from .renderer import Renderer
