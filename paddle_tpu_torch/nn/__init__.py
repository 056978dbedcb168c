"""The port's ``nn``: layers, containers, initializers, gradient clipping,
recurrent layers and beam search."""

from . import functional  # noqa: F401
from .layers import Layer  # noqa: F401
from . import initializer  # noqa: F401
from .activation import *  # noqa: F401,F403
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm,
    ClipGradByNorm,
    ClipGradByValue,
)
from .common import (  # noqa: F401
    AlphaDropout,
    Bilinear,
    ChannelShuffle,
    CosineSimilarity,
    Dropout,
    Dropout2D,
    Dropout3D,
    Embedding,
    Flatten,
    Fold,
    Identity,
    Linear,
    Pad1D,
    Pad2D,
    Pad3D,
    PairwiseDistance,
    PixelShuffle,
    PixelUnshuffle,
    Unflatten,
    Unfold,
    Upsample,
    UpsamplingBilinear2D,
    UpsamplingNearest2D,
    ZeroPad2D,
)
from .container import (  # noqa: F401
    LayerDict,
    LayerList,
    ParameterList,
    Sequential,
)
from .conv import (  # noqa: F401
    Conv1D,
    Conv1DTranspose,
    Conv2D,
    Conv2DTranspose,
    Conv3D,
    Conv3DTranspose,
)
from .loss import *  # noqa: F401,F403
from .norm import (  # noqa: F401
    BatchNorm,
    BatchNorm1D,
    BatchNorm2D,
    BatchNorm3D,
    GroupNorm,
    InstanceNorm1D,
    InstanceNorm2D,
    InstanceNorm3D,
    LayerNorm,
    LocalResponseNorm,
    RMSNorm,
    SyncBatchNorm,
)
from .pooling import (  # noqa: F401
    AdaptiveAvgPool1D,
    AdaptiveAvgPool2D,
    AdaptiveAvgPool3D,
    AdaptiveMaxPool1D,
    AdaptiveMaxPool2D,
    AdaptiveMaxPool3D,
    AvgPool1D,
    AvgPool2D,
    AvgPool3D,
    LPPool1D,
    LPPool2D,
    MaxPool1D,
    MaxPool2D,
    MaxPool3D,
)
from .decode import (  # noqa: F401
    BeamSearchDecoder,
    Decoder,
    dynamic_decode,
)
from .rnn import (  # noqa: F401
    GRU,
    LSTM,
    RNN,
    BiRNN,
    GRUCell,
    LSTMCell,
    RNNCellBase,
    SimpleRNN,
    SimpleRNNCell,
)
from .transformer import (  # noqa: F401
    MultiHeadAttention,
    Transformer,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoder,
    TransformerEncoderLayer,
)
