"""One module per kind of entry the program offers (a traffic file's
``entry``): each builds the program from the configuration, feeds it the
traffic, times the window and judges its outputs against the reference."""
