"""One generator a kind of traffic, named by a traffic file's `loop`."""
