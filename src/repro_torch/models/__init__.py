"""Model layer of the port: `layers`, `attention` (plain references),
`blocks` and `model` (the paged step family).  Import from the modules
themselves; this package re-exports nothing, so the kernels can import
`models.attention` for their plain versions without an import cycle."""
