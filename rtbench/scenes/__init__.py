"""Scene kinds: how each configuration's scene is made, handed to the
program's build and to the reference.  One module a kind, found by the
`scene` key of a configuration's file."""
