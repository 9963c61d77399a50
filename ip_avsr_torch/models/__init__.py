"""Model definitions of the port (AdeNet composer, encoders, zoo)."""
