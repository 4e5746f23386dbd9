"""Networks and the AnchorColorProb composition (counterparts of the JAX ``models``)."""

from . import anchor  # noqa: F401
from .colorprobnet import ColorProbNet  # noqa: F401
from .disco import AnchorColorProb, xavier_reinit_params  # noqa: F401
from .hourglass import HourGlass2  # noqa: F401
from .position import sine_position_encoding  # noqa: F401
from .spixelnet import SpixelNet, SpixelSeg  # noqa: F401
from .transformer import EncoderLayer, MultiheadAttention, TransformerEncoder  # noqa: F401
from .vgg import VGG19Features, load_vgg19  # noqa: F401
