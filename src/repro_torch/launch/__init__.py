"""Entry points and step helpers of the port."""
