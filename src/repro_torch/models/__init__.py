"""Models of the port: the Keyword Transformer (``kwt``) over the shared
``layers``.  The LM families are a later slice."""
