"""Multi-device execution on ``torch.distributed`` (counterpart of
``basic_dsp_tpu/parallel``): the polyphase channelizer and FM demod, and
the sharded functions over a device mesh (``config.make_mesh``).  Sample
blocks become shards of a ``DTensor``; the overlap that a block-wise
convolution, resampler or filterbank carries between blocks becomes a
point-to-point halo exchange between ring neighbours
(``collectives.shift_from_left/right``); the mergeable statistics partials
cross in one all-gather; the distributed four-step FFT (``sharded_fft``)
transposes with all-to-alls, and the channel-parallel MIMO convolution
(``mimo``) mixes channels with one reduce-scatter."""
from . import collectives, sharded_fft
from .channelizer import (ChannelizeAndDemodPlanar, channelize_and_demod,
                          channelize_and_demod_planar, fm_demodulate,
                          polyphase_channelizer,
                          sharded_channelize_and_demod)
from .mimo import sharded_convolve_mat
from .sharded import (shard_time_axis, sharded_convolve_signal,
                      sharded_interpolatef, sharded_statistics, sharded_sum)

__all__ = ["ChannelizeAndDemodPlanar", "channelize_and_demod",
           "channelize_and_demod_planar", "collectives", "fm_demodulate",
           "polyphase_channelizer", "shard_time_axis",
           "sharded_channelize_and_demod", "sharded_convolve_mat",
           "sharded_convolve_signal", "sharded_fft",
           "sharded_interpolatef", "sharded_statistics", "sharded_sum"]
