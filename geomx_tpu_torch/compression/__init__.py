from geomx_tpu_torch.compression.codecs import (  # noqa: F401
    Codec, CodecError, Fp16Codec, TwoBitCodec, BscCodec, MpqSelector,
    BroadcastCompressor, make_push_codec, decompress_payload,
    DecoderBank, compression_allowed, KNOWN_PUSH_TAGS, WEIGHT_SAFE_CODECS,
)
