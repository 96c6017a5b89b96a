from .channel import ChannelInfo, ModularChannel  # noqa: F401
from .predict import Predictor  # noqa: F401
