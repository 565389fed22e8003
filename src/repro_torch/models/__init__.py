"""Model stack of the port: layers, attention, the decoder backbone."""
