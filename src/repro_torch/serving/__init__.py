"""Serving layer of the port: the scheduler-side modules copied from
`repro.serving`, plus the torch engines (`real_engine`) and `server`."""
