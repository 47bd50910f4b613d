from .channel_mapper import ChannelMapper

__all__ = ["ChannelMapper"]
