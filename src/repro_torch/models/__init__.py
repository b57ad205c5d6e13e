"""Models of the port: the Keyword Transformer (``kwt``), the decoder-only
LMs (``transformer`` over ``moe``, ``rwkv`` and ``ssm``) and the
encoder-decoder (``encdec``), over the shared ``layers``."""
