"""Window loops, one module a kind of traffic (a traffic file's `loop`)."""
