"""Channelizer of the port (counterpart of ``basic_dsp_tpu/parallel``): the
polyphase filterbank and FM demod on one device.  The mesh-sharded
functions of the JAX package are not ported yet."""
from .channelizer import (ChannelizeAndDemodPlanar, channelize_and_demod,
                          channelize_and_demod_planar, fm_demodulate,
                          polyphase_channelizer)

__all__ = ["ChannelizeAndDemodPlanar", "channelize_and_demod",
           "channelize_and_demod_planar", "fm_demodulate",
           "polyphase_channelizer"]
