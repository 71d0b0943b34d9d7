"""Native (C++) runtime components, bound via ctypes and built at first use."""
