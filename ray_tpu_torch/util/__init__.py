"""Process-local observability for the port: the device plane's program
registry (``util.device_plane``)."""
